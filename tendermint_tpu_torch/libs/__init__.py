"""Host utilities: protoio (varint wire), bits (BitArray), log, service,
metrics, events (the event switch), pubsub (the queryable event server),
fail (crash points), autofile (the WAL's file group), flowrate, tmjson
(amino JSON) with bytes (HexBytes), math, clist, cmap, rand, timer, sync
(the deadlock and event-loop watchdogs) and cli (the node's global
flags)."""
