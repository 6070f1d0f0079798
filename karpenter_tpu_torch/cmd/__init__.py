"""Entry-point binaries (ref: cmd/controller, cmd/webhook)."""
