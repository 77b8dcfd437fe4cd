"""Consensus pieces the verify path needs: the self-clocking micro-batcher
and the vote batcher that routes through the dispatch scheduler."""
