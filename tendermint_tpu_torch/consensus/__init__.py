"""The consensus core: the Tendermint state machine (``state_machine``)
with its WAL, replay, commit pipeline and adaptive pacing, and the
batchers that route its signature checks: the self-clocking
micro-batcher, the vote batcher and the batch-point BLS batcher."""
