# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dra.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tdra.proto\x12#k8s.io.kubelet.pkg.apis.dra.v1beta1\"5\n\x05\x43laim\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x0b\n\x03uid\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\"Y\n\x1bNodePrepareResourcesRequest\x12:\n\x06\x63laims\x18\x01 \x03(\x0b\x32*.k8s.io.kubelet.pkg.apis.dra.v1beta1.Claim\"\xee\x01\n\x1cNodePrepareResourcesResponse\x12]\n\x06\x63laims\x18\x01 \x03(\x0b\x32M.k8s.io.kubelet.pkg.apis.dra.v1beta1.NodePrepareResourcesResponse.ClaimsEntry\x1ao\n\x0b\x43laimsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12O\n\x05value\x18\x02 \x01(\x0b\x32@.k8s.io.kubelet.pkg.apis.dra.v1beta1.NodePrepareResourceResponse:\x02\x38\x01\"j\n\x1bNodePrepareResourceResponse\x12<\n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32+.k8s.io.kubelet.pkg.apis.dra.v1beta1.Device\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"_\n\x06\x44\x65vice\x12\x15\n\rrequest_names\x18\x01 \x03(\t\x12\x11\n\tpool_name\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65vice_name\x18\x03 \x01(\t\x12\x16\n\x0e\x63\x64i_device_ids\x18\x04 \x03(\t\"[\n\x1dNodeUnprepareResourcesRequest\x12:\n\x06\x63laims\x18\x01 \x03(\x0b\x32*.k8s.io.kubelet.pkg.apis.dra.v1beta1.Claim\"\xf4\x01\n\x1eNodeUnprepareResourcesResponse\x12_\n\x06\x63laims\x18\x01 \x03(\x0b\x32O.k8s.io.kubelet.pkg.apis.dra.v1beta1.NodeUnprepareResourcesResponse.ClaimsEntry\x1aq\n\x0b\x43laimsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12Q\n\x05value\x18\x02 \x01(\x0b\x32\x42.k8s.io.kubelet.pkg.apis.dra.v1beta1.NodeUnprepareResourceResponse:\x02\x38\x01\".\n\x1dNodeUnprepareResourceResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t2\xd1\x02\n\tDRAPlugin\x12\x9d\x01\n\x14NodePrepareResources\x12@.k8s.io.kubelet.pkg.apis.dra.v1beta1.NodePrepareResourcesRequest\x1a\x41.k8s.io.kubelet.pkg.apis.dra.v1beta1.NodePrepareResourcesResponse\"\x00\x12\xa3\x01\n\x16NodeUnprepareResources\x12\x42.k8s.io.kubelet.pkg.apis.dra.v1beta1.NodeUnprepareResourcesRequest\x1a\x43.k8s.io.kubelet.pkg.apis.dra.v1beta1.NodeUnprepareResourcesResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dra_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._options = None
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_options = b'8\001'
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._options = None
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_options = b'8\001'
  _CLAIM._serialized_start=50
  _CLAIM._serialized_end=103
  _NODEPREPARERESOURCESREQUEST._serialized_start=105
  _NODEPREPARERESOURCESREQUEST._serialized_end=194
  _NODEPREPARERESOURCESRESPONSE._serialized_start=197
  _NODEPREPARERESOURCESRESPONSE._serialized_end=435
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_start=324
  _NODEPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_end=435
  _NODEPREPARERESOURCERESPONSE._serialized_start=437
  _NODEPREPARERESOURCERESPONSE._serialized_end=543
  _DEVICE._serialized_start=545
  _DEVICE._serialized_end=640
  _NODEUNPREPARERESOURCESREQUEST._serialized_start=642
  _NODEUNPREPARERESOURCESREQUEST._serialized_end=733
  _NODEUNPREPARERESOURCESRESPONSE._serialized_start=736
  _NODEUNPREPARERESOURCESRESPONSE._serialized_end=980
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_start=867
  _NODEUNPREPARERESOURCESRESPONSE_CLAIMSENTRY._serialized_end=980
  _NODEUNPREPARERESOURCERESPONSE._serialized_start=982
  _NODEUNPREPARERESOURCERESPONSE._serialized_end=1028
  _DRAPLUGIN._serialized_start=1031
  _DRAPLUGIN._serialized_end=1368
# @@protoc_insertion_point(module_scope)
