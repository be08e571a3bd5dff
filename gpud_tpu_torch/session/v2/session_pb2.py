# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: gpud_tpu/session/v2/session.proto (copied with its descriptor: the
# same proto file, so both packages can load it into one descriptor pool)
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n!gpud_tpu/session/v2/session.proto\x12\x0ftpud.session.v2\"\xc6\x01\n\x05Hello\x12\x12\n\nmachine_id\x18\x01 \x01(\t\x12\r\n\x05token\x18\x02 \x01(\t\x12\x15\n\rmachine_proof\x18\x03 \x01(\t\x12\x14\n\x0ctpud_version\x18\x04 \x01(\t\x12\x10\n\x08revision\x18\x05 \x01(\x05\x12\x14\n\x0cmin_revision\x18\x06 \x01(\r\x12\x14\n\x0cmax_revision\x18\x07 \x01(\r\x12\x14\n\x0c\x63\x61pabilities\x18\x08 \x03(\t\x12\x19\n\x11max_message_bytes\x18\t \x01(\r\"v\n\x08HelloAck\x12\x10\n\x08\x61\x63\x63\x65pted\x18\x01 \x01(\x08\x12\x0e\n\x06reason\x18\x02 \x01(\t\x12\x10\n\x08revision\x18\x03 \x01(\x05\x12\x1b\n\x13manager_instance_id\x18\x04 \x01(\t\x12\x19\n\x11max_message_bytes\x18\x05 \x01(\r\"%\n\x05\x46rame\x12\x0e\n\x06req_id\x18\x01 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x02 \x01(\x0c\"4\n\x0b\x44rainNotice\x12\x0e\n\x06reason\x18\x01 \x01(\t\x12\x15\n\rdeadline_unix\x18\x02 \x01(\x03\"2\n\x06Result\x12\x12\n\nrequest_id\x18\x01 \x01(\t\x12\x14\n\x0cpayload_json\x18\x02 \x01(\x0c\"\x95\x01\n\x0b\x41gentPacket\x12\'\n\x05hello\x18\x01 \x01(\x0b\x32\x16.tpud.session.v2.HelloH\x00\x12\'\n\x05\x66rame\x18\x02 \x01(\x0b\x32\x16.tpud.session.v2.FrameH\x00\x12)\n\x06result\x18\x03 \x01(\x0b\x32\x17.tpud.session.v2.ResultH\x00\x42\t\n\x07payload\"&\n\x10GetStatesRequest\x12\x12\n\ncomponents\x18\x01 \x03(\t\"&\n\x10GetEventsRequest\x12\x12\n\nsince_unix\x18\x01 \x01(\x01\"\'\n\x11GetMetricsRequest\x12\x12\n\nsince_unix\x18\x01 \x01(\x01\"\x0f\n\rGossipRequest\"W\n\x11\x44iagnosticRequest\x12\x15\n\rscript_base64\x18\x01 \x01(\t\x12\x12\n\nsince_unix\x18\x02 \x01(\x01\x12\x17\n\x0ftimeout_seconds\x18\x03 \x01(\x01\"&\n\rRebootRequest\x12\x15\n\rdelay_seconds\x18\x01 \x01(\x01\"&\n\x11SetHealthyRequest\x12\x11\n\tcomponent\x18\x01 \x01(\t\"9\n\x17TriggerComponentRequest\x12\x11\n\tcomponent\x18\x01 \x01(\t\x12\x0b\n\x03tag\x18\x02 \x01(\t\"/\n\x1a\x44\x65registerComponentRequest\x12\x11\n\tcomponent\x18\x01 \x01(\t\"D\n\rKernelMessage\x12\x15\n\x08priority\x18\x01 \x01(\x05H\x00\x88\x01\x01\x12\x0f\n\x07message\x18\x02 \x01(\tB\x0b\n\t_priority\"\x92\x01\n\x12InjectFaultRequest\x12\x18\n\x0etpu_error_name\x18\x01 \x01(\tH\x00\x12\x38\n\x0ekernel_message\x18\x02 \x01(\x0b\x32\x1e.tpud.session.v2.KernelMessageH\x00\x12\x0f\n\x07\x63hip_id\x18\x03 \x01(\x05\x12\x0e\n\x06\x64\x65tail\x18\x04 \x01(\tB\x07\n\x05\x66\x61ult\"B\n\x10\x42ootstrapRequest\x12\x15\n\rscript_base64\x18\x01 \x01(\t\x12\x17\n\x0ftimeout_seconds\x18\x02 \x01(\x01\"\x96\x01\n\x13UpdateConfigRequest\x12K\n\x0c\x63onfigs_json\x18\x01 \x03(\x0b\x32\x35.tpud.session.v2.UpdateConfigRequest.ConfigsJsonEntry\x1a\x32\n\x10\x43onfigsJsonEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"#\n\x12UpdateTokenRequest\x12\r\n\x05token\x18\x01 \x01(\t\"\x11\n\x0fGetTokenRequest\"\x0f\n\rLogoutRequest\"\x16\n\x14\x44\x65leteMachineRequest\"\x19\n\x17GetPackageStatusRequest\" \n\rUpdateRequest\x12\x0f\n\x07version\x18\x01 \x01(\t\"\x16\n\x14KapMtlsStatusRequest\"g\n\x1fKapMtlsUpdateCredentialsRequest\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x10\n\x08\x63\x65rt_pem\x18\x02 \x01(\t\x12\x0f\n\x07key_pem\x18\x03 \x01(\t\x12\x10\n\x08\x61\x63tivate\x18\x04 \x01(\x08\")\n\x16KapMtlsActivateRequest\x12\x0f\n\x07version\x18\x01 \x01(\t\"\x17\n\x15GetPluginSpecsRequest\"o\n\x0fPluginMatchRule\x12\r\n\x05regex\x18\x01 \x01(\t\x12\r\n\x05\x66ield\x18\x02 \x01(\t\x12\x0e\n\x06health\x18\x03 \x01(\t\x12\x19\n\x11suggested_actions\x18\x04 \x03(\t\x12\x13\n\x0b\x64\x65scription\x18\x05 \x01(\t\"\xc5\x01\n\x12PluginOutputParser\x12\x46\n\njson_paths\x18\x01 \x03(\x0b\x32\x32.tpud.session.v2.PluginOutputParser.JsonPathsEntry\x12\x35\n\x0bmatch_rules\x18\x02 \x03(\x0b\x32 .tpud.session.v2.PluginMatchRule\x1a\x30\n\x0eJsonPathsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"A\n\nPluginStep\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06script\x18\x02 \x01(\t\x12\x15\n\rscript_base64\x18\x03 \x01(\t\"\xfb\x01\n\nPluginSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x13\n\x0bplugin_type\x18\x02 \x01(\t\x12\x10\n\x08run_mode\x18\x03 \x01(\t\x12\x18\n\x10interval_seconds\x18\x04 \x01(\x01\x12\x17\n\x0ftimeout_seconds\x18\x05 \x01(\x01\x12*\n\x05steps\x18\x06 \x03(\x0b\x32\x1b.tpud.session.v2.PluginStep\x12\x33\n\x06parser\x18\x07 \x01(\x0b\x32#.tpud.session.v2.PluginOutputParser\x12\x0c\n\x04tags\x18\x08 \x03(\t\x12\x16\n\x0e\x63omponent_list\x18\t \x03(\t\"C\n\x15SetPluginSpecsRequest\x12*\n\x05specs\x18\x01 \x03(\x0b\x32\x1b.tpud.session.v2.PluginSpec\"\xd5\x0c\n\rManagerPacket\x12\x12\n\nrequest_id\x18\x04 \x01(\t\x12.\n\thello_ack\x18\x01 \x01(\x0b\x32\x19.tpud.session.v2.HelloAckH\x00\x12\'\n\x05\x66rame\x18\x02 \x01(\x0b\x32\x16.tpud.session.v2.FrameH\x00\x12\x34\n\x0c\x64rain_notice\x18\x03 \x01(\x0b\x32\x1c.tpud.session.v2.DrainNoticeH\x00\x12\x37\n\nget_states\x18\n \x01(\x0b\x32!.tpud.session.v2.GetStatesRequestH\x00\x12\x37\n\nget_events\x18\x0b \x01(\x0b\x32!.tpud.session.v2.GetEventsRequestH\x00\x12\x39\n\x0bget_metrics\x18\x0c \x01(\x0b\x32\".tpud.session.v2.GetMetricsRequestH\x00\x12\x30\n\x06gossip\x18\r \x01(\x0b\x32\x1e.tpud.session.v2.GossipRequestH\x00\x12\x38\n\ndiagnostic\x18\x0e \x01(\x0b\x32\".tpud.session.v2.DiagnosticRequestH\x00\x12\x30\n\x06reboot\x18\x0f \x01(\x0b\x32\x1e.tpud.session.v2.RebootRequestH\x00\x12\x39\n\x0bset_healthy\x18\x10 \x01(\x0b\x32\".tpud.session.v2.SetHealthyRequestH\x00\x12\x45\n\x11trigger_component\x18\x11 \x01(\x0b\x32(.tpud.session.v2.TriggerComponentRequestH\x00\x12K\n\x14\x64\x65register_component\x18\x12 \x01(\x0b\x32+.tpud.session.v2.DeregisterComponentRequestH\x00\x12;\n\x0cinject_fault\x18\x13 \x01(\x0b\x32#.tpud.session.v2.InjectFaultRequestH\x00\x12\x36\n\tbootstrap\x18\x14 \x01(\x0b\x32!.tpud.session.v2.BootstrapRequestH\x00\x12=\n\rupdate_config\x18\x15 \x01(\x0b\x32$.tpud.session.v2.UpdateConfigRequestH\x00\x12;\n\x0cupdate_token\x18\x16 \x01(\x0b\x32#.tpud.session.v2.UpdateTokenRequestH\x00\x12\x35\n\tget_token\x18\x17 \x01(\x0b\x32 .tpud.session.v2.GetTokenRequestH\x00\x12\x30\n\x06logout\x18\x18 \x01(\x0b\x32\x1e.tpud.session.v2.LogoutRequestH\x00\x12?\n\x0e\x64\x65lete_machine\x18\x19 \x01(\x0b\x32%.tpud.session.v2.DeleteMachineRequestH\x00\x12\x46\n\x12get_package_status\x18\x1a \x01(\x0b\x32(.tpud.session.v2.GetPackageStatusRequestH\x00\x12\x30\n\x06update\x18\x1b \x01(\x0b\x32\x1e.tpud.session.v2.UpdateRequestH\x00\x12@\n\x0fkap_mtls_status\x18\x1c \x01(\x0b\x32%.tpud.session.v2.KapMtlsStatusRequestH\x00\x12W\n\x1bkap_mtls_update_credentials\x18\x1d \x01(\x0b\x32\x30.tpud.session.v2.KapMtlsUpdateCredentialsRequestH\x00\x12\x44\n\x11kap_mtls_activate\x18\x1e \x01(\x0b\x32\'.tpud.session.v2.KapMtlsActivateRequestH\x00\x12\x42\n\x10get_plugin_specs\x18\x1f \x01(\x0b\x32&.tpud.session.v2.GetPluginSpecsRequestH\x00\x12\x42\n\x10set_plugin_specs\x18  \x01(\x0b\x32&.tpud.session.v2.SetPluginSpecsRequestH\x00\x42\t\n\x07payloadb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'gpud_tpu_torch.session.v2.session_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _UPDATECONFIGREQUEST_CONFIGSJSONENTRY._options = None
  _UPDATECONFIGREQUEST_CONFIGSJSONENTRY._serialized_options = b'8\001'
  _PLUGINOUTPUTPARSER_JSONPATHSENTRY._options = None
  _PLUGINOUTPUTPARSER_JSONPATHSENTRY._serialized_options = b'8\001'
  _HELLO._serialized_start=55
  _HELLO._serialized_end=253
  _HELLOACK._serialized_start=255
  _HELLOACK._serialized_end=373
  _FRAME._serialized_start=375
  _FRAME._serialized_end=412
  _DRAINNOTICE._serialized_start=414
  _DRAINNOTICE._serialized_end=466
  _RESULT._serialized_start=468
  _RESULT._serialized_end=518
  _AGENTPACKET._serialized_start=521
  _AGENTPACKET._serialized_end=670
  _GETSTATESREQUEST._serialized_start=672
  _GETSTATESREQUEST._serialized_end=710
  _GETEVENTSREQUEST._serialized_start=712
  _GETEVENTSREQUEST._serialized_end=750
  _GETMETRICSREQUEST._serialized_start=752
  _GETMETRICSREQUEST._serialized_end=791
  _GOSSIPREQUEST._serialized_start=793
  _GOSSIPREQUEST._serialized_end=808
  _DIAGNOSTICREQUEST._serialized_start=810
  _DIAGNOSTICREQUEST._serialized_end=897
  _REBOOTREQUEST._serialized_start=899
  _REBOOTREQUEST._serialized_end=937
  _SETHEALTHYREQUEST._serialized_start=939
  _SETHEALTHYREQUEST._serialized_end=977
  _TRIGGERCOMPONENTREQUEST._serialized_start=979
  _TRIGGERCOMPONENTREQUEST._serialized_end=1036
  _DEREGISTERCOMPONENTREQUEST._serialized_start=1038
  _DEREGISTERCOMPONENTREQUEST._serialized_end=1085
  _KERNELMESSAGE._serialized_start=1087
  _KERNELMESSAGE._serialized_end=1155
  _INJECTFAULTREQUEST._serialized_start=1158
  _INJECTFAULTREQUEST._serialized_end=1304
  _BOOTSTRAPREQUEST._serialized_start=1306
  _BOOTSTRAPREQUEST._serialized_end=1372
  _UPDATECONFIGREQUEST._serialized_start=1375
  _UPDATECONFIGREQUEST._serialized_end=1525
  _UPDATECONFIGREQUEST_CONFIGSJSONENTRY._serialized_start=1475
  _UPDATECONFIGREQUEST_CONFIGSJSONENTRY._serialized_end=1525
  _UPDATETOKENREQUEST._serialized_start=1527
  _UPDATETOKENREQUEST._serialized_end=1562
  _GETTOKENREQUEST._serialized_start=1564
  _GETTOKENREQUEST._serialized_end=1581
  _LOGOUTREQUEST._serialized_start=1583
  _LOGOUTREQUEST._serialized_end=1598
  _DELETEMACHINEREQUEST._serialized_start=1600
  _DELETEMACHINEREQUEST._serialized_end=1622
  _GETPACKAGESTATUSREQUEST._serialized_start=1624
  _GETPACKAGESTATUSREQUEST._serialized_end=1649
  _UPDATEREQUEST._serialized_start=1651
  _UPDATEREQUEST._serialized_end=1683
  _KAPMTLSSTATUSREQUEST._serialized_start=1685
  _KAPMTLSSTATUSREQUEST._serialized_end=1707
  _KAPMTLSUPDATECREDENTIALSREQUEST._serialized_start=1709
  _KAPMTLSUPDATECREDENTIALSREQUEST._serialized_end=1812
  _KAPMTLSACTIVATEREQUEST._serialized_start=1814
  _KAPMTLSACTIVATEREQUEST._serialized_end=1855
  _GETPLUGINSPECSREQUEST._serialized_start=1857
  _GETPLUGINSPECSREQUEST._serialized_end=1880
  _PLUGINMATCHRULE._serialized_start=1882
  _PLUGINMATCHRULE._serialized_end=1993
  _PLUGINOUTPUTPARSER._serialized_start=1996
  _PLUGINOUTPUTPARSER._serialized_end=2193
  _PLUGINOUTPUTPARSER_JSONPATHSENTRY._serialized_start=2145
  _PLUGINOUTPUTPARSER_JSONPATHSENTRY._serialized_end=2193
  _PLUGINSTEP._serialized_start=2195
  _PLUGINSTEP._serialized_end=2260
  _PLUGINSPEC._serialized_start=2263
  _PLUGINSPEC._serialized_end=2514
  _SETPLUGINSPECSREQUEST._serialized_start=2516
  _SETPLUGINSPECSREQUEST._serialized_end=2583
  _MANAGERPACKET._serialized_start=2586
  _MANAGERPACKET._serialized_end=4207
# @@protoc_insertion_point(module_scope)
