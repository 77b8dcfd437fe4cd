"""Host utilities the commit path needs: protoio (varint wire), bits
(BitArray)."""
