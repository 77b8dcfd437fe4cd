"""Host utilities: protoio (varint wire), bits (BitArray), log, service,
metrics, events (the event switch), fail (crash points) and autofile
(the WAL's file group)."""
