"""The tools, each run as ``python -m tendermint_tpu_torch.tools.<name>``:
``prewarm`` (the verify-launch prewarm manifest, over
``BatchVerifier.prewarm_buckets``), ``device_report`` (the device-cost
ledger's tables), ``bench_trend`` (the bench-trajectory trend and gate),
``cluster_trace`` and ``trace_report`` (the flight recorder's cluster and
per-node reports), ``pacing_report`` (wall per height: timeout floor,
gossip, compute, and the pacing decisions), ``testnet_generator`` (seeded
testnet manifests and homes), ``loadtime`` (tx load through a node, and the
sequencer streaming net); the harnesses ``verify_service_bench`` (a
committee's rounds across processes into one verify service),
``qc_bench`` (N-signature commits against one QC pairing),
``bench_replay`` (a blocksync window against the per-block loop),
``lightserve_bench`` (a light-client swarm and its attack scenarios) and
``soak`` (seeded chaos scenarios); ``signer_harness`` (remote-signer
conformance) and ``fsync_bench`` (the WAL's fsync on this disk).
``_inproc`` holds the in-proc validator net they build on."""
