# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: solver.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0csolver.proto\x12\x13karpenter.solver.v1\"4\n\x06Tensor\x12\r\n\x05shape\x18\x01 \x03(\x03\x12\r\n\x05\x64type\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\"\x84\x03\n\x0cSolveRequest\x12\x32\n\rgroup_vectors\x18\x01 \x01(\x0b\x32\x1b.karpenter.solver.v1.Tensor\x12\x31\n\x0cgroup_counts\x18\x02 \x01(\x0b\x32\x1b.karpenter.solver.v1.Tensor\x12-\n\x08\x63\x61pacity\x18\x03 \x01(\x0b\x32\x1b.karpenter.solver.v1.Tensor\x12*\n\x05total\x18\x04 \x01(\x0b\x32\x1b.karpenter.solver.v1.Tensor\x12+\n\x06prices\x18\x05 \x01(\x0b\x32\x1b.karpenter.solver.v1.Tensor\x12\x30\n\x0bpool_prices\x18\x06 \x01(\x0b\x32\x1b.karpenter.solver.v1.Tensor\x12\r\n\x05zones\x18\x07 \x03(\t\x12\x15\n\rcapacity_type\x18\x08 \x01(\t\x12\x0c\n\x04mode\x18\t \x01(\t\x12\x10\n\x08lp_steps\x18\n \x01(\x05\x12\r\n\x05quirk\x18\x0b \x01(\x08\"@\n\x07PoolRow\x12\x12\n\ntype_index\x18\x01 \x01(\x05\x12\x12\n\nzone_index\x18\x02 \x01(\x05\x12\r\n\x05price\x18\x03 \x01(\x01\"a\n\tOptionSet\x12\x14\n\x0ctype_indices\x18\x01 \x03(\x05\x12+\n\x05pools\x18\x02 \x03(\x0b\x32\x1c.karpenter.solver.v1.PoolRow\x12\x11\n\thas_pools\x18\x03 \x01(\x08\"o\n\x05Round\x12\x12\n\ntype_index\x18\x01 \x01(\x05\x12)\n\x04\x66ill\x18\x02 \x01(\x0b\x32\x1b.karpenter.solver.v1.Tensor\x12\x13\n\x0breplication\x18\x03 \x01(\x05\x12\x12\n\noption_set\x18\x04 \x01(\x05\"\xd8\x01\n\rSolveResponse\x12*\n\x06rounds\x18\x01 \x03(\x0b\x32\x1a.karpenter.solver.v1.Round\x12\x32\n\runschedulable\x18\x02 \x01(\x0b\x32\x1b.karpenter.solver.v1.Tensor\x12\x33\n\x0boption_sets\x18\x03 \x03(\x0b\x32\x1e.karpenter.solver.v1.OptionSet\x12\x0e\n\x06solver\x18\x04 \x01(\t\x12\x10\n\x08solve_ms\x18\x05 \x01(\x01\x12\x10\n\x08\x66\x61llback\x18\x06 \x01(\x08\"\x0f\n\rHealthRequest\"X\n\x0eHealthResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x10\n\x08platform\x18\x02 \x01(\t\x12\x14\n\x0c\x64\x65vice_count\x18\x03 \x01(\x05\x12\x0e\n\x06solves\x18\x04 \x01(\x04\x32\x85\x02\n\x06Solver\x12N\n\x05Solve\x12!.karpenter.solver.v1.SolveRequest\x1a\".karpenter.solver.v1.SolveResponse\x12X\n\x0bSolveStream\x12!.karpenter.solver.v1.SolveRequest\x1a\".karpenter.solver.v1.SolveResponse(\x01\x30\x01\x12Q\n\x06Health\x12\".karpenter.solver.v1.HealthRequest\x1a#.karpenter.solver.v1.HealthResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'solver_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSOR._serialized_start=37
  _TENSOR._serialized_end=89
  _SOLVEREQUEST._serialized_start=92
  _SOLVEREQUEST._serialized_end=480
  _POOLROW._serialized_start=482
  _POOLROW._serialized_end=546
  _OPTIONSET._serialized_start=548
  _OPTIONSET._serialized_end=645
  _ROUND._serialized_start=647
  _ROUND._serialized_end=758
  _SOLVERESPONSE._serialized_start=761
  _SOLVERESPONSE._serialized_end=977
  _HEALTHREQUEST._serialized_start=979
  _HEALTHREQUEST._serialized_end=994
  _HEALTHRESPONSE._serialized_start=996
  _HEALTHRESPONSE._serialized_end=1084
  _SOLVER._serialized_start=1087
  _SOLVER._serialized_end=1348
# @@protoc_insertion_point(module_scope)
