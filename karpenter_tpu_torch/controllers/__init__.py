"""Control plane: the reconciler shell around the solver.

Ref layout (pkg/controllers/*): selection routes unschedulable pods to
provisioners; provisioning batches + solves + launches + binds; termination
drains and deletes; node runs lifecycle sub-reconcilers; counter aggregates
capacity; metrics publishes gauges. The kube-apiserver is replaced by the
in-memory Cluster state store (controllers/cluster.py), which tests and the
single-process runtime share.
"""
