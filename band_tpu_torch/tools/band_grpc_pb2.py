# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: band_grpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0f\x62\x61nd_grpc.proto\x12\x04\x62\x61nd\"\x07\n\x05\x45mpty\"2\n\x0bHealthReply\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x13\n\x0bnum_workers\x18\x02 \x01(\x05\"4\n\x06Tensor\x12\r\n\x05shape\x18\x01 \x03(\x03\x12\r\n\x05\x64type\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\"9\n\nTensorInfo\x12\r\n\x05index\x18\x01 \x01(\x05\x12\r\n\x05shape\x18\x02 \x03(\x03\x12\r\n\x05\x64type\x18\x03 \x01(\t\"\x93\x01\n\tModelInfo\x12\x10\n\x08model_id\x18\x01 \x01(\x05\x12\x0c\n\x04name\x18\x02 \x01(\t\x12 \n\x06inputs\x18\x03 \x03(\x0b\x32\x10.band.TensorInfo\x12!\n\x07outputs\x18\x04 \x03(\x0b\x32\x10.band.TensorInfo\x12\x0e\n\x06worker\x18\x05 \x01(\x05\x12\x11\n\tsubgraphs\x18\x06 \x01(\x05\"-\n\nModelTable\x12\x1f\n\x06models\x18\x01 \x03(\x0b\x32\x0f.band.ModelInfo\"M\n\x0fRegisterRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x1a\n\rtarget_worker\x18\x02 \x01(\x05H\x00\x88\x01\x01\x42\x10\n\x0e_target_worker\"!\n\rRegisterReply\x12\x10\n\x08model_id\x18\x01 \x01(\x05\"\x1b\n\x07ModelId\x12\x10\n\x08model_id\x18\x01 \x01(\x05\"\xaf\x01\n\x0cInferRequest\x12\x10\n\x08model_id\x18\x01 \x01(\x05\x12\x1c\n\x06inputs\x18\x02 \x03(\x0b\x32\x0c.band.Tensor\x12\x0e\n\x06slo_us\x18\x03 \x01(\x03\x12\x11\n\tslo_scale\x18\x04 \x01(\x01\x12\x1a\n\rtarget_worker\x18\x05 \x01(\x05H\x00\x88\x01\x01\x12\x11\n\ttimeout_s\x18\x06 \x01(\x01\x12\x0b\n\x03seq\x18\x07 \x01(\x04\x42\x10\n\x0e_target_worker\"e\n\nInferReply\x12\x1d\n\x07outputs\x18\x01 \x03(\x0b\x32\x0c.band.Tensor\x12\x0b\n\x03seq\x18\x02 \x01(\x04\x12\x0e\n\x06job_id\x18\x03 \x01(\x03\x12\x0c\n\x04\x63ode\x18\x04 \x01(\x05\x12\r\n\x05\x65rror\x18\x05 \x01(\t\"\x17\n\x05JobId\x12\x0e\n\x06job_id\x18\x01 \x01(\x03\"0\n\x0bWaitRequest\x12\x0e\n\x06job_id\x18\x01 \x01(\x03\x12\x11\n\ttimeout_s\x18\x02 \x01(\x01\"\xa5\x01\n\nModelStats\x12\x17\n\x0f\x65xecution_count\x18\x01 \x01(\x03\x12\x44\n\x13\x65xpected_latency_us\x18\x02 \x03(\x0b\x32\'.band.ModelStats.ExpectedLatencyUsEntry\x1a\x38\n\x16\x45xpectedLatencyUsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\"{\n\nStatsReply\x12,\n\x06models\x18\x01 \x03(\x0b\x32\x1c.band.StatsReply.ModelsEntry\x1a?\n\x0bModelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\x05\x12\x1f\n\x05value\x18\x02 \x01(\x0b\x32\x10.band.ModelStats:\x02\x38\x01\x32\xc2\x03\n\nBandEngine\x12(\n\x06Health\x12\x0b.band.Empty\x1a\x11.band.HealthReply\x12+\n\nListModels\x12\x0b.band.Empty\x1a\x10.band.ModelTable\x12;\n\rRegisterModel\x12\x15.band.RegisterRequest\x1a\x13.band.RegisterReply\x12-\n\x0fUnregisterModel\x12\r.band.ModelId\x1a\x0b.band.Empty\x12/\n\x07Request\x12\x12.band.InferRequest\x1a\x10.band.InferReply\x12/\n\x0cRequestAsync\x12\x12.band.InferRequest\x1a\x0b.band.JobId\x12+\n\x04Wait\x12\x11.band.WaitRequest\x1a\x10.band.InferReply\x12&\n\x05Stats\x12\x0b.band.Empty\x1a\x10.band.StatsReply\x12:\n\x0eStreamRequests\x12\x12.band.InferRequest\x1a\x10.band.InferReply(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'band_grpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MODELSTATS_EXPECTEDLATENCYUSENTRY._options = None
  _MODELSTATS_EXPECTEDLATENCYUSENTRY._serialized_options = b'8\001'
  _STATSREPLY_MODELSENTRY._options = None
  _STATSREPLY_MODELSENTRY._serialized_options = b'8\001'
  _EMPTY._serialized_start=25
  _EMPTY._serialized_end=32
  _HEALTHREPLY._serialized_start=34
  _HEALTHREPLY._serialized_end=84
  _TENSOR._serialized_start=86
  _TENSOR._serialized_end=138
  _TENSORINFO._serialized_start=140
  _TENSORINFO._serialized_end=197
  _MODELINFO._serialized_start=200
  _MODELINFO._serialized_end=347
  _MODELTABLE._serialized_start=349
  _MODELTABLE._serialized_end=394
  _REGISTERREQUEST._serialized_start=396
  _REGISTERREQUEST._serialized_end=473
  _REGISTERREPLY._serialized_start=475
  _REGISTERREPLY._serialized_end=508
  _MODELID._serialized_start=510
  _MODELID._serialized_end=537
  _INFERREQUEST._serialized_start=540
  _INFERREQUEST._serialized_end=715
  _INFERREPLY._serialized_start=717
  _INFERREPLY._serialized_end=818
  _JOBID._serialized_start=820
  _JOBID._serialized_end=843
  _WAITREQUEST._serialized_start=845
  _WAITREQUEST._serialized_end=893
  _MODELSTATS._serialized_start=896
  _MODELSTATS._serialized_end=1061
  _MODELSTATS_EXPECTEDLATENCYUSENTRY._serialized_start=1005
  _MODELSTATS_EXPECTEDLATENCYUSENTRY._serialized_end=1061
  _STATSREPLY._serialized_start=1063
  _STATSREPLY._serialized_end=1186
  _STATSREPLY_MODELSENTRY._serialized_start=1123
  _STATSREPLY_MODELSENTRY._serialized_end=1186
  _BANDENGINE._serialized_start=1189
  _BANDENGINE._serialized_end=1639
# @@protoc_insertion_point(module_scope)
