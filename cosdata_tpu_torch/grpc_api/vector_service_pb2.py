# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: vector_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import empty_pb2 as google_dot_protobuf_dot_empty__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x14vector_service.proto\x12\x0evector_service\x1a\x1bgoogle/protobuf/empty.proto\"*\n\nSparsePair\x12\r\n\x05index\x18\x01 \x01(\r\x12\r\n\x05value\x18\x02 \x01(\x02\"B\n\nFieldValue\x12\x16\n\x0cstring_value\x18\x01 \x01(\tH\x00\x12\x13\n\tint_value\x18\x02 \x01(\x03H\x00\x42\x07\n\x05value\"\xa8\x02\n\x06Vector\x12\n\n\x02id\x18\x01 \x01(\t\x12\x18\n\x0b\x64ocument_id\x18\x02 \x01(\tH\x00\x88\x01\x01\x12\x14\n\x0c\x64\x65nse_values\x18\x03 \x03(\x02\x12\x31\n\rsparse_values\x18\x04 \x03(\x0b\x32\x1a.vector_service.SparsePair\x12\x11\n\x04text\x18\x05 \x01(\tH\x01\x88\x01\x01\x12\x36\n\x08metadata\x18\x06 \x03(\x0b\x32$.vector_service.Vector.MetadataEntry\x1aK\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12)\n\x05value\x18\x02 \x01(\x0b\x32\x1a.vector_service.FieldValue:\x02\x38\x01\x42\x0e\n\x0c_document_idB\x07\n\x05_text\":\n\x14\x43reateSessionRequest\x12\x10\n\x08username\x18\x01 \x01(\t\x12\x10\n\x08password\x18\x02 \x01(\t\"U\n\x15\x43reateSessionResponse\x12\x14\n\x0c\x61\x63\x63\x65ss_token\x18\x01 \x01(\t\x12\x12\n\ncreated_at\x18\x02 \x01(\x03\x12\x12\n\nexpires_at\x18\x03 \x01(\x03\"8\n\x12\x44\x65nseVectorOptions\x12\x0f\n\x07\x65nabled\x18\x01 \x01(\x08\x12\x11\n\tdimension\x18\x02 \x01(\r\"&\n\x13SparseVectorOptions\x12\x0f\n\x07\x65nabled\x18\x01 \x01(\x08\"\x1f\n\x0cTFIDFOptions\x12\x0f\n\x07\x65nabled\x18\x01 \x01(\x08\"t\n\x10\x43ollectionConfig\x12\x18\n\x0bmax_vectors\x18\x01 \x01(\rH\x00\x88\x01\x01\x12\x1f\n\x12replication_factor\x18\x02 \x01(\rH\x01\x88\x01\x01\x42\x0e\n\x0c_max_vectorsB\x15\n\x13_replication_factor\"\xc7\x02\n\x17\x43reateCollectionRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x18\n\x0b\x64\x65scription\x18\x02 \x01(\tH\x00\x88\x01\x01\x12\x38\n\x0c\x64\x65nse_vector\x18\x03 \x01(\x0b\x32\".vector_service.DenseVectorOptions\x12:\n\rsparse_vector\x18\x04 \x01(\x0b\x32#.vector_service.SparseVectorOptions\x12\x34\n\x0etf_idf_options\x18\x05 \x01(\x0b\x32\x1c.vector_service.TFIDFOptions\x12\x30\n\x06\x63onfig\x18\x06 \x01(\x0b\x32 .vector_service.CollectionConfig\x12\x16\n\x0estore_raw_text\x18\x07 \x01(\x08\x42\x0e\n\x0c_description\"(\n\x18\x43reateCollectionResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x17\n\x15GetCollectionsRequest\"I\n\x16GetCollectionsResponse\x12/\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x1a.vector_service.Collection\"\xf0\x01\n\nCollection\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x18\n\x0b\x64\x65scription\x18\x02 \x01(\tH\x00\x88\x01\x01\x12\x38\n\x0c\x64\x65nse_vector\x18\x03 \x01(\x0b\x32\".vector_service.DenseVectorOptions\x12:\n\rsparse_vector\x18\x04 \x01(\x0b\x32#.vector_service.SparseVectorOptions\x12\x34\n\x0etf_idf_options\x18\x05 \x01(\x0b\x32\x1c.vector_service.TFIDFOptionsB\x0e\n\x0c_description\"-\n\x14GetCollectionRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\"0\n\x17\x44\x65leteCollectionRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\"\'\n\x0bValuesRange\x12\x0b\n\x03min\x18\x01 \x01(\x02\x12\x0b\n\x03max\x18\x02 \x01(\x02\",\n\x10\x41utoQuantization\x12\x18\n\x10sample_threshold\x18\x01 \x01(\r\"S\n\x12ScalarQuantization\x12\x11\n\tdata_type\x18\x01 \x01(\t\x12*\n\x05range\x18\x02 \x01(\x0b\x32\x1b.vector_service.ValuesRange\"\xfc\x01\n\nHNSWParams\x12\x17\n\nnum_layers\x18\x01 \x01(\rH\x00\x88\x01\x01\x12\x1a\n\rnum_neighbors\x18\x02 \x01(\rH\x01\x88\x01\x01\x12$\n\x17level_0_neighbors_count\x18\x03 \x01(\rH\x02\x88\x01\x01\x12\x1c\n\x0f\x65\x66_construction\x18\x04 \x01(\rH\x03\x88\x01\x01\x12\x16\n\tef_search\x18\x05 \x01(\rH\x04\x88\x01\x01\x42\r\n\x0b_num_layersB\x10\n\x0e_num_neighborsB\x1a\n\x18_level_0_neighbors_countB\x12\n\x10_ef_constructionB\x0c\n\n_ef_search\"\xf7\x01\n\x17\x43reateDenseIndexRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\x12\x1c\n\x14\x64istance_metric_type\x18\x02 \x01(\t\x12\x30\n\x04\x61uto\x18\x03 \x01(\x0b\x32 .vector_service.AutoQuantizationH\x00\x12\x34\n\x06scalar\x18\x04 \x01(\x0b\x32\".vector_service.ScalarQuantizationH\x00\x12/\n\x0bhnsw_params\x18\x05 \x01(\x0b\x32\x1a.vector_service.HNSWParamsB\x0e\n\x0cquantization\"\x91\x01\n\x18\x43reateSparseIndexRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\x12\x19\n\x0cquantization\x18\x02 \x01(\rH\x00\x88\x01\x01\x12\x1d\n\x10sample_threshold\x18\x03 \x01(\rH\x01\x88\x01\x01\x42\x0f\n\r_quantizationB\x13\n\x11_sample_threshold\"\x92\x01\n\x17\x43reateTFIDFIndexRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\x12\x0f\n\x02k1\x18\x02 \x01(\x02H\x00\x88\x01\x01\x12\x0e\n\x01\x62\x18\x03 \x01(\x02H\x01\x88\x01\x01\x12\x1d\n\x10sample_threshold\x18\x04 \x01(\rH\x02\x88\x01\x01\x42\x05\n\x03_k1B\x04\n\x02_bB\x13\n\x11_sample_threshold\"1\n\x18\x43reateTransactionRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\"G\n\x19\x43reateTransactionResponse\x12\x16\n\x0etransaction_id\x18\x01 \x01(\t\x12\x12\n\ncreated_at\x18\x02 \x01(\x03\"I\n\x18\x43ommitTransactionRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\x12\x16\n\x0etransaction_id\x18\x02 \x01(\t\"H\n\x17\x41\x62ortTransactionRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\x12\x16\n\x0etransaction_id\x18\x02 \x01(\t\"y\n CreateVectorInTransactionRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\x12\x16\n\x0etransaction_id\x18\x02 \x01(\t\x12&\n\x06vector\x18\x03 \x01(\x0b\x32\x16.vector_service.Vector\"d\n DeleteVectorInTransactionRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\x12\x16\n\x0etransaction_id\x18\x02 \x01(\t\x12\x11\n\tvector_id\x18\x03 \x01(\t\"n\n\x14UpsertVectorsRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\x12\x16\n\x0etransaction_id\x18\x02 \x01(\t\x12\'\n\x07vectors\x18\x03 \x03(\x0b\x32\x16.vector_service.Vector\"8\n\x0eVectorResponse\x12&\n\x06vector\x18\x01 \x01(\x0b\x32\x16.vector_service.Vector\"<\n\x10GetVectorRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\x12\x11\n\tvector_id\x18\x02 \x01(\t\"L\n\x1c\x46indSimilarDenseVectorsQuery\x12\x0e\n\x06vector\x18\x01 \x03(\x02\x12\x12\n\x05top_k\x18\x02 \x01(\rH\x00\x88\x01\x01\x42\x08\n\x06_top_k\"\xaf\x01\n\x1d\x46indSimilarSparseVectorsQuery\x12*\n\x06values\x18\x01 \x03(\x0b\x32\x1a.vector_service.SparsePair\x12\x12\n\x05top_k\x18\x02 \x01(\rH\x00\x88\x01\x01\x12&\n\x19\x65\x61rly_terminate_threshold\x18\x03 \x01(\x02H\x01\x88\x01\x01\x42\x08\n\x06_top_kB\x1c\n\x1a_early_terminate_threshold\"L\n\x1d\x46indSimilarTFIDFDocumentQuery\x12\r\n\x05query\x18\x01 \x01(\t\x12\x12\n\x05top_k\x18\x02 \x01(\rH\x00\x88\x01\x01\x42\x08\n\x06_top_k\"\xfc\x01\n\x19\x46indSimilarVectorsRequest\x12\x15\n\rcollection_id\x18\x01 \x01(\t\x12=\n\x05\x64\x65nse\x18\x02 \x01(\x0b\x32,.vector_service.FindSimilarDenseVectorsQueryH\x00\x12?\n\x06sparse\x18\x03 \x01(\x0b\x32-.vector_service.FindSimilarSparseVectorsQueryH\x00\x12?\n\x06tf_idf\x18\x04 \x01(\x0b\x32-.vector_service.FindSimilarTFIDFDocumentQueryH\x00\x42\x07\n\x05query\"Y\n\x12SimilarVectorMatch\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x02\x12\x18\n\x0b\x64ocument_id\x18\x03 \x01(\tH\x00\x88\x01\x01\x42\x0e\n\x0c_document_id\"Q\n\x1a\x46indSimilarVectorsResponse\x12\x33\n\x07matches\x18\x01 \x03(\x0b\x32\".vector_service.SimilarVectorMatch2k\n\x0b\x41uthService\x12\\\n\rCreateSession\x12$.vector_service.CreateSessionRequest\x1a%.vector_service.CreateSessionResponse2\x84\x03\n\x12\x43ollectionsService\x12\x65\n\x10\x43reateCollection\x12\'.vector_service.CreateCollectionRequest\x1a(.vector_service.CreateCollectionResponse\x12_\n\x0eGetCollections\x12%.vector_service.GetCollectionsRequest\x1a&.vector_service.GetCollectionsResponse\x12Q\n\rGetCollection\x12$.vector_service.GetCollectionRequest\x1a\x1a.vector_service.Collection\x12S\n\x10\x44\x65leteCollection\x12\'.vector_service.DeleteCollectionRequest\x1a\x16.google.protobuf.Empty2\x91\x02\n\x0eIndexesService\x12S\n\x10\x43reateDenseIndex\x12\'.vector_service.CreateDenseIndexRequest\x1a\x16.google.protobuf.Empty\x12U\n\x11\x43reateSparseIndex\x12(.vector_service.CreateSparseIndexRequest\x1a\x16.google.protobuf.Empty\x12S\n\x10\x43reateTFIDFIndex\x12\'.vector_service.CreateTFIDFIndexRequest\x1a\x16.google.protobuf.Empty2\xc8\x04\n\x13TransactionsService\x12h\n\x11\x43reateTransaction\x12(.vector_service.CreateTransactionRequest\x1a).vector_service.CreateTransactionResponse\x12U\n\x11\x43ommitTransaction\x12(.vector_service.CommitTransactionRequest\x1a\x16.google.protobuf.Empty\x12S\n\x10\x41\x62ortTransaction\x12\'.vector_service.AbortTransactionRequest\x1a\x16.google.protobuf.Empty\x12\x65\n\x19\x43reateVectorInTransaction\x12\x30.vector_service.CreateVectorInTransactionRequest\x1a\x16.google.protobuf.Empty\x12\x65\n\x19\x44\x65leteVectorInTransaction\x12\x30.vector_service.DeleteVectorInTransactionRequest\x1a\x16.google.protobuf.Empty\x12M\n\rUpsertVectors\x12$.vector_service.UpsertVectorsRequest\x1a\x16.google.protobuf.Empty2\xcc\x01\n\x0eVectorsService\x12M\n\tGetVector\x12 .vector_service.GetVectorRequest\x1a\x1e.vector_service.VectorResponse\x12k\n\x12\x46indSimilarVectors\x12).vector_service.FindSimilarVectorsRequest\x1a*.vector_service.FindSimilarVectorsResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'vector_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VECTOR_METADATAENTRY._options = None
  _VECTOR_METADATAENTRY._serialized_options = b'8\001'
  _SPARSEPAIR._serialized_start=69
  _SPARSEPAIR._serialized_end=111
  _FIELDVALUE._serialized_start=113
  _FIELDVALUE._serialized_end=179
  _VECTOR._serialized_start=182
  _VECTOR._serialized_end=478
  _VECTOR_METADATAENTRY._serialized_start=378
  _VECTOR_METADATAENTRY._serialized_end=453
  _CREATESESSIONREQUEST._serialized_start=480
  _CREATESESSIONREQUEST._serialized_end=538
  _CREATESESSIONRESPONSE._serialized_start=540
  _CREATESESSIONRESPONSE._serialized_end=625
  _DENSEVECTOROPTIONS._serialized_start=627
  _DENSEVECTOROPTIONS._serialized_end=683
  _SPARSEVECTOROPTIONS._serialized_start=685
  _SPARSEVECTOROPTIONS._serialized_end=723
  _TFIDFOPTIONS._serialized_start=725
  _TFIDFOPTIONS._serialized_end=756
  _COLLECTIONCONFIG._serialized_start=758
  _COLLECTIONCONFIG._serialized_end=874
  _CREATECOLLECTIONREQUEST._serialized_start=877
  _CREATECOLLECTIONREQUEST._serialized_end=1204
  _CREATECOLLECTIONRESPONSE._serialized_start=1206
  _CREATECOLLECTIONRESPONSE._serialized_end=1246
  _GETCOLLECTIONSREQUEST._serialized_start=1248
  _GETCOLLECTIONSREQUEST._serialized_end=1271
  _GETCOLLECTIONSRESPONSE._serialized_start=1273
  _GETCOLLECTIONSRESPONSE._serialized_end=1346
  _COLLECTION._serialized_start=1349
  _COLLECTION._serialized_end=1589
  _GETCOLLECTIONREQUEST._serialized_start=1591
  _GETCOLLECTIONREQUEST._serialized_end=1636
  _DELETECOLLECTIONREQUEST._serialized_start=1638
  _DELETECOLLECTIONREQUEST._serialized_end=1686
  _VALUESRANGE._serialized_start=1688
  _VALUESRANGE._serialized_end=1727
  _AUTOQUANTIZATION._serialized_start=1729
  _AUTOQUANTIZATION._serialized_end=1773
  _SCALARQUANTIZATION._serialized_start=1775
  _SCALARQUANTIZATION._serialized_end=1858
  _HNSWPARAMS._serialized_start=1861
  _HNSWPARAMS._serialized_end=2113
  _CREATEDENSEINDEXREQUEST._serialized_start=2116
  _CREATEDENSEINDEXREQUEST._serialized_end=2363
  _CREATESPARSEINDEXREQUEST._serialized_start=2366
  _CREATESPARSEINDEXREQUEST._serialized_end=2511
  _CREATETFIDFINDEXREQUEST._serialized_start=2514
  _CREATETFIDFINDEXREQUEST._serialized_end=2660
  _CREATETRANSACTIONREQUEST._serialized_start=2662
  _CREATETRANSACTIONREQUEST._serialized_end=2711
  _CREATETRANSACTIONRESPONSE._serialized_start=2713
  _CREATETRANSACTIONRESPONSE._serialized_end=2784
  _COMMITTRANSACTIONREQUEST._serialized_start=2786
  _COMMITTRANSACTIONREQUEST._serialized_end=2859
  _ABORTTRANSACTIONREQUEST._serialized_start=2861
  _ABORTTRANSACTIONREQUEST._serialized_end=2933
  _CREATEVECTORINTRANSACTIONREQUEST._serialized_start=2935
  _CREATEVECTORINTRANSACTIONREQUEST._serialized_end=3056
  _DELETEVECTORINTRANSACTIONREQUEST._serialized_start=3058
  _DELETEVECTORINTRANSACTIONREQUEST._serialized_end=3158
  _UPSERTVECTORSREQUEST._serialized_start=3160
  _UPSERTVECTORSREQUEST._serialized_end=3270
  _VECTORRESPONSE._serialized_start=3272
  _VECTORRESPONSE._serialized_end=3328
  _GETVECTORREQUEST._serialized_start=3330
  _GETVECTORREQUEST._serialized_end=3390
  _FINDSIMILARDENSEVECTORSQUERY._serialized_start=3392
  _FINDSIMILARDENSEVECTORSQUERY._serialized_end=3468
  _FINDSIMILARSPARSEVECTORSQUERY._serialized_start=3471
  _FINDSIMILARSPARSEVECTORSQUERY._serialized_end=3646
  _FINDSIMILARTFIDFDOCUMENTQUERY._serialized_start=3648
  _FINDSIMILARTFIDFDOCUMENTQUERY._serialized_end=3724
  _FINDSIMILARVECTORSREQUEST._serialized_start=3727
  _FINDSIMILARVECTORSREQUEST._serialized_end=3979
  _SIMILARVECTORMATCH._serialized_start=3981
  _SIMILARVECTORMATCH._serialized_end=4070
  _FINDSIMILARVECTORSRESPONSE._serialized_start=4072
  _FINDSIMILARVECTORSRESPONSE._serialized_end=4153
  _AUTHSERVICE._serialized_start=4155
  _AUTHSERVICE._serialized_end=4262
  _COLLECTIONSSERVICE._serialized_start=4265
  _COLLECTIONSSERVICE._serialized_end=4653
  _INDEXESSERVICE._serialized_start=4656
  _INDEXESSERVICE._serialized_end=4929
  _TRANSACTIONSSERVICE._serialized_start=4932
  _TRANSACTIONSSERVICE._serialized_end=5516
  _VECTORSSERVICE._serialized_start=5519
  _VECTORSSERVICE._serialized_end=5723
# @@protoc_insertion_point(module_scope)
