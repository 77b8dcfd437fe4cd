#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--seed N] [--validators N] [--heights N]

Phases (any failure raises and the exit code is non-zero):

1. Build the ed25519, SHA-512, BLS12-381, secp256k1 and SHA-256 kernels from
   ``tendermint_tpu_torch/ops/csrc`` into ``tendermint_tpu_torch/_kbuild/``
   (a ``-Xptxas -v`` report of registers and spills per kernel runs beside
   the build), print the build seconds and the card's ``nvidia-smi`` name
   and power limit.
2. Hold each ed25519/SHA-512 kernel against its plain PyTorch version on
   the card, on the same inputs, with exact equality (bytes and bitmaps are
   integers): ``neg_pubkey_table`` and ``neg_pubkey_bigtable`` on 256 keys
   (valid plus adversarial: small order, non-canonical y, no square root,
   x = 0 with the sign bit), the four-lane ``neg_pubkey_table`` also at 1,
   23 and 150 of them (``kernel2_key_sets``: adversarial keys inside
   warps of valid ones), ``verify_prehashed_table`` and
   ``verify_prehashed`` on 256 mixed valid/invalid rows,
   ``verify_prehashed_bigcache`` and ``_mxu`` on 2048 such rows (each also
   held against the host oracle; in phase 4 also at the bulk window's
   16,384 rows, the tampered commit included, against the plain versions
   and the window's bitmap), ``challenge_batch`` on 2048 ragged rows
   and the first 1,000 of them (a partial last warp), each against its
   plain version and hashlib + % L (in phase 4 also at the bulk window's
   16,384 rows against the plain version and the host challenges), the
   reduction kernel alone on adversarial
   digests, the four-lane ``dbl_chain`` on 8192 points x 256 doublings and
   on their first 150 (a partial last warp; bytes and affine coordinates,
   row 0 against 256 host ``point_double``). The four-lane
   ``verify_prehashed_table`` also at its small-tier shapes
   (``KERNEL3_SIZES``: b = 1, 23, 150 and 256, the last the commit path's
   150 rows padded to its bucket), with ``idx = -1``, ``idx`` past the
   store and padding rows inside warps of live rows, against its plain
   version and the host oracle; the four-lane ``verify_prehashed`` at
   the same shapes (``kernel4_rows``: a zero padding row and a valid
   signature with ``s_ok`` False inside warps of live rows).
3. Drive the main paths through their entry points, each with the launch
   counts zeroed just before and read just after:
   - commit verification: a seeded 150-validator ``ValidatorSet``
     verifies 5 heights of precommits through ``default_verifier()`` on
     CUDA, rejects a tampered signature with the reference's
     ``wrong signature at index i``, and a ``BatchVerifier`` whose table
     cache holds 64 keys verifies one 150-row round on the generic kernel,
     held against the host oracle;
   - the doubling chain: ``dbl_chain`` at the Pallas microbenchmark's
     workload (8192 points, 256 doublings);
   - bulk commit verification, as blocksync catches up: 64 commits of the
     150-validator set (9600 signatures, bucket 16384: the big tier), one
     with the signatures of validators holding more than 1/3 of the power
     tampered, verified by ``ValidatorSet.verify_commits_light`` from an
     executor thread through a started ``VerifyScheduler`` and
     ``default_dispatch("blocksync")``: twice with challenges hashed on
     the host (the first window builds the big tables), twice with
     challenges hashed on the card (``device_challenge_min=2048``), once
     under ``TM_TPU_MXU_GATHER=1``. Each run's verdicts, the per-row bitmap
     of the window (also a seeded sample against the host oracle) and the
     scheduler's ledger round are checked.
4. Time each kernel (median of 20 launches, CUDA events) and its plain
   version (median of 3) at the main paths' shapes, ``verify_commit`` per
   height (beside its figure with the one-thread kernel 3), and the bulk
   window's wall time with its host and device shares; work out each
   kernel's bound. Kernel 3 also at the buckets 8, 32, 128 and 256 (the
   ``kernel3:`` line), kernel 4 likewise (``kernel4:``), kernel 6 at 2,048
   rows and the window's 16,384 (``kernel6:``), kernel 5 at 256
   adversarial keys and the window's build (``kernel5:``), kernel 2 at 1,
   23, 150 and 256 keys (``kernel2:``) and kernel 8's hash at the 2,048
   ragged rows, the first 1,000 of them and the window's 16,384
   (``kernel8:``), kernel 1 at 1, 150 and 8,192 points (``kernel1:``),
   each line with the four-lane critical path or the bound and ``ptxas``
   usage.
5. The quorum-certificate path (``qc_phase``): ``g1_aggregate`` and
   ``g2_aggregate`` on 256 points with duplicates, opposites and the
   identity and at the device route's shapes (150 signatures; 150 keys),
   ``miller`` and ``final_exp`` (one warp a 2-pair chunk, one warp an
   element) on the 2-pair verify shape, a 65-pair
   random-linear-combination shape and ``pairing_operands``' adversarial
   operands (limbs 0, 1, p - 1 and >= p, off-curve points, invalid and
   all-invalid chunks, the zero element), each against its plain version
   on the card byte for byte, the products against the host oracle, and
   bilinearity of ``pairing_value``; then BLS keys for the 150 validators (4 through
   ``pubkey_from_priv``, whose proof of possession is a native pairing; the
   rest trusted keys, as set-up), QC shares on the bulk window's 64
   commits, then both BLS routes of the JAX package's order, each with
   the launch counts read: the native route (``TM_TPU_BLS_PAIRING_DEVICE``
   unset: native pairing and MSM, no BLS kernel may launch) and the device
   route (the gate set: every pairing check on the card, and each QC's
   signature sum and signer-key sum again through
   ``aggregate_signatures_device`` / ``aggregate_public_keys_device``,
   equal to the native sums). On each route ``assemble_qc`` for each
   commit (the two routes' certificates equal), QC 40 replaced by a
   sub-quorum aggregate under the full bitset, and
   ``ValidatorSet.verify_commits_qc`` over the window from an executor
   thread through a started ``VerifyScheduler``'s ``qc_verify`` lane,
   twice: verdicts ``[True]*39 + [False] + [True]*24``, one ledger round
   each. Timings: each BLS kernel (median of 20) and its plain version
   (one call, the comparison at the device route's shape),
   ``check_pairs`` on the card against the native host library's
   ``pairing_check`` on the same pairs, each route's assembly per QC (on
   the device route also the 64 signature and signer-key sums on the
   card, host clock) and its window walls split into signature and key
   parse, hash-to-G1, scalar multiplications and pairing checks,
   ``g1_aggregate`` and ``g2_aggregate`` also at the 64-tree forest,
   against the plain version and the host oracle; the ``kernel12:`` line
   gives ``tm_miller`` at both shapes, ``tm_final_exp``, their critical
   paths (``FP_MILLER_PATH``, ``FP_FINAL_EXP_PATH``) and ``ptxas`` usage.
6. The mixed-key path and the L2 block's merkle leaves (``mixed_phase``):
   ``secp_verify_prehashed`` on 64 crafted rows (valid, flipped s, wrong
   message, cross key, ``ok_in`` False, Q = G with u1 = u2, R at infinity,
   a point with x >= n taking the direct and the wrapped compare, the
   forged wrap r = x - n + 2^256, u1 = u2 = 0) and ``sha256_batch`` on
   one-block rows, 2-block inner rows, the leaf batch of the L2 block
   (ragged block counts) and its first 1,000 rows (a partial last warp),
   each against its plain version on the card, the JAX package's rule or
   hashlib (the ``kernel9:`` line times ``sha256_batch`` at those shapes). Then a validator set of the 150 keys in
   which every third holds a secp256k1 key (equal power), with
   ``TM_TPU_SECP_DEVICE=1``: ``verify_commit`` on 5 heights (the 50
   secp256k1 rows on the kernel, a tampered secp256k1 signature rejected
   with the reference's message) and ``verify_commits_light`` over a
   64-commit window (6,400 ed25519 rows on the big tier, 3,200 secp256k1
   rows on the kernel; commit 40 with tampered ed25519 and secp256k1
   signatures of more than 1/3 of the power) from an executor thread
   through a started ``VerifyScheduler``, twice, each wall split into
   secp256k1 host prep, the kernel with its copies, the ed25519 round and
   sign-bytes assembly; the secp256k1 rows against the native host route
   (also timed, as the yardstick), a sample against the host oracles. Then
   ``Data.hash()`` of an L2 block (4,000 transactions of 100-1,024 bytes
   and 2 payload leaves) with the device gate at 1,024 leaves, and
   ``merkle_root_pow2`` over 4,096 leaves, both equal to the host tree.
   Launch counts are read after each path; timings: both kernels (median
   of 20) at the path's shapes with their bounds, the per-height and
   window walls, the native and device routes of the 3,200 rows, the
   merkle block by the card (``pad_messages`` apart) and by hashlib. The
   ``kernel10:`` line gives the secp256k1 kernel (four lanes a row) at the
   window's 8,192 rows and at a mesh shard's 1,024 (400 live, the window's
   share of live rows), its critical path against one thread a row
   (``secp_lane_path``, ``secp_fe_muls``, the mean over the window's live
   rows) and ``ptxas`` usage.
7. The in-process consensus net (``consensus_phase``): ``NET_VALIDATORS``
   (32) validators in this process, wired with the full-mesh
   broadcast hook, each a ``ConsensusState`` over ``KVStoreApplication``
   through ``LocalClient``, ``MemKV`` stores, ``MockL2Node`` and ``MockPV``,
   on the process verifier (the card) behind one started
   ``VerifyScheduler`` as the process default. Mode (a), legacy commits,
   and mode (b), quorum certificates with batch points every 2 blocks
   whose precommits carry BLS dual-signatures checked by the L2 mock's
   registry verifier (the pairing gate unset), and mode (c), legacy commits
   over encrypted p2p: each node a ``NodeKey`` from the seed, a
   ``MultiplexTransport`` on 127.0.0.1, a ``Switch`` and a
   ``ConsensusReactor(vote_batch=True)``, ring plus chords of
   ``NET_PEER_DEGREE`` (4), every gossiped vote pre-verified by the node's
   ``VoteBatcher`` through the scheduler; the native AEAD
   (``_tmcrypto.so``) must load first. Each runs to
   ``NET_HEIGHTS`` (1) heights plus one. Checks: every node the same block (so
   the same app hash) at every height, every stored LastCommit signature
   true by the host oracle, the ledger's consensus-class rounds (modes a
   and c: signature rounds from ``min_device_batch`` rows, at least one per
   height; mode b: ``qc_verify`` rounds), small-tier launches in modes (a)
   and (c) (big-tier ones where a round reaches 512 rows; in mode c on
   rounds that carry ``VoteBatcher`` rows, and no vote a node's batcher
   passed checked again by its state machine), BLS data at every
   sealed batch point and no BLS launch in any mode; in modes (a) and (c)
   every small-tier round's verdicts, as the net got them, equal the plain
   version (mode a: each at its dispatched shape; mode c: the rounds' rows
   together, ``plain_over_rounds``). Prints the walls per height, rows and
   buckets per round, mode (c)'s vote rounds, and the device and host
   shares; the net's launches add to the kernels line.
8. The multi-device path (``mesh_phase``) over a ``Mesh`` of
   ``MESH_SHARDS`` (8) shards, all on ``cuda:0``: every line of the
   sharded path (the row split, the table store copied per distinct
   device, a launch per shard, the gather, the local trees and the XOR
   butterfly) with the JAX tests' shard count, on one card. Kernel 13,
   ``g1_aggregate_sharded`` and ``g2_aggregate_sharded`` (the trees of
   rows 11a/11b and the new ``g1_add``/``g2_add`` butterfly kernels), on
   the QC window's 150 signatures and 150 keys, the 256 adversarial points
   and 5 points, each against its plain version on the CPU (bytes) and the
   host sum. The blocksync window (the same 64 commits, 9,600 rows, bucket
   16,384, 2,048 rows a shard) through a started ``VerifyScheduler`` over
   ``BatchVerifier(mesh=...)``, host-hashed x2, card-hashed x2
   (``device_challenge_min=2048``) and MXU x1: verdicts and per-row bitmap
   equal to phase 3's 1-device window's, every round stamped
   ``devices=8`` and sharded, the ``verify_mesh_devices`` gauge 8; one
   150-row commit (below ``mesh_min_rows``) stamped ``devices=1``; the
   phase-3 commit round sharded on the small tier and the generic kernel
   (``mesh_min_rows=1``); ``prewarm_buckets`` with both device variants
   where the ladder allows; the secp256k1 kernel sharded over the mixed
   window's 8,192 rows (3,200 live), equal to the unsharded launch;
   ``g1_add`` and ``g2_add`` each on one launch of ``BRANCH_PAIRS`` (a
   pair for every branch of the addition) against their plain versions.
   Times:
   the add kernels, kernel 13 with its bound, the windows beside phase 3's,
   the secp256k1 rows sharded and not. Where ``torch.cuda.device_count()``
   is 2 or more, kernel 13, the host-hashed window and the secp256k1
   launch again over ``build_mesh(0, 1, "cuda")``; else it prints
   ``mesh: real multi-GPU mesh not run (1 device)``. The path's launches
   add to the kernels line, which gains ``g1_add`` and ``g2_add``. The
   ``g2sums:`` line then gives the warp-wide G2 sums (``g2_aggregate`` at
   one tree and the forest, ``g2_add``, the sharded G2 sum), their
   critical paths against one thread an addition (``g2_tree_paths``,
   ``FP_G2_ADD_KERNEL_PATH``, ``FP_G2_ADD_PATH``) and ``ptxas`` usage;
   the ``g1sums:`` line the same for the G1 sums on lane groups
   (``g1_tree_paths``, ``FP_G1_ADD_KERNEL_PATH``, ``FP_G1_ADD_PATH``).
9. The catch-up path (``catchup_phase``): a node that joins or restarts
   catches up. The served chain: ``CATCHUP_HEIGHTS`` (129) heights of the
   seeded 150-validator set of phases 3-4, built through the port's
   ``BlockExecutor`` (``create_proposal_block`` with ``CATCHUP_TXS`` (3)
   kvstore transactions of the mock L2 node, every precommit signed into a
   ``VoteSet``, ``make_commit()``, ``apply_block``, ``save_block``). Mode
   (a): a fresh node blocksyncs it from genesis over encrypted p2p through
   ``BlocksyncReactor.start_sync()`` from two honest servers
   (``BlocksyncReactor(active=False)`` over copies of the source's block
   store, each its own ``NodeKey``, ``MultiplexTransport`` on 127.0.0.1
   and ``Switch``), its windows through ``default_dispatch("blocksync")``
   and one started ``VerifyScheduler`` onto kernels 5 and 6, each applied
   block's LastCommit check onto kernel 3. Mode (b): the same with a third,
   lying server whose block ``CATCHUP_LIAR_BLOCK`` (12) carries a
   LastCommit with the signatures of more than 1/3 of the power tampered,
   dialed first and alone until the client's pool has asked it for that
   block. Checks: height 128 reached and ``on_caught_up`` fired; every
   block hash and the app hash after every height equal the source's;
   kernel 6 launched (and kernel 5 in mode a); every window round equal to
   its plain version at its shape, the applied blocks' small-tier rounds
   through the plain version together (``plain_over_rounds``), a seeded
   sample of rows against the host oracle; in (b) a window verdict flags
   height 11, the pool punishes the lying peer alone and it leaves the
   client's switch. Mode (c): ``LightClient`` trusted at height 1, its
   primary and one witness ``StoreProvider`` over the source's stores,
   verifies to 128 sequentially (128 rounds of 150 rows) and by skipping,
   every round through ``default_dispatch("light")`` onto kernel 3, and
   rejects height 11 served with the tampered commit (its tampered rows
   alone false, as the host oracle says). Prints the AEAD route, each mode's
   ms to catch up and commits/s, each window round's commits, rows, bucket
   and tier, the wall split into window rounds, per-block verifies outside
   ``apply_block``, ``apply_block`` with its LastCommit check apart, and
   the rest (waiting on the pool or p2p, the reactor's own work), the
   device busy share and the launches, beside phase 3's bare window of the
   same run; for (c) ms a step, sequential and skipping. The launches add
   to the kernels line.
10. The bulk rest and the chaos mesh (``bulk_rest_phase``), over phase 9's
   chain, each part with the launch counts zeroed just before and read just
   after, every verify round it caused held against the plain version
   (``check_recorded``). (a) ``SWARM_CLIENTS`` (1,000) ``LightClient``s sync
   from the trust root at height 1 to 128 through one ``LightServePlane``
   over the source's stores (the client loop and scenarios of
   ``tendermint_tpu_torch.tools.lightserve_bench``, through
   ``tests/torch_lightserve_swarm.py``), its ``ServeVerifier`` on a started
   ``VerifyScheduler``'s ``lightserve`` lane; then the swarm's divergent-witness scenario (a fork re-signed by
   the 150 keys, the honest plane as witness: ``LightClientAttackEvidence``
   into the honest node's ``EvidencePool``) and forged-header scenario (the
   tampered witness removed). Checks: every client synced, hit rate > 0.9,
   dedup rate > 0.99, executed verifications and device rounds far below
   the client count. (b) That evidence through the honest node's pool
   (``default_dispatch("evidence")``) and over encrypted p2p by its
   ``EvidenceReactor`` into a second node's pool, both accepting it; a copy
   with the heaviest third's signatures flipped rejected, the verdict on a
   copy with one flipped reported (both packages' tally accepts it); a
   ``DuplicateVoteEvidence`` of one validator accepted on the host oracle
   (2 rows, under ``min_device_batch``) and its flipped copy rejected. (c)
   ``CHAOS_VALIDATORS`` (16) validators over encrypted p2p
   (``tests/torch_chaos_harness.py``, ``device="cuda"``) under a seeded
   ``ScenarioRunner``: the storm of ``tests/test_chaos.py`` to height 4,
   an even partition that commits nothing for 2 s, healed, two heights, n3
   killed, one height, n3 restarted, one height; one chain at every
   height; kernel 2's tables of the 16 new keys against the plain version;
   the storm under a ``ProfileCapture``'s loop profile (``device=False``,
   armed on the mesh's event-loop thread), its samples' shares by the port
   directory of their innermost frame (p2p, crypto/aead, chaos, consensus;
   ``loop_shares``). (d) The backend guard: ``probe_backend()`` on the card, ``meta_block``,
   a hanging child killed at its bound. Prints each part's figures (clients
   a second, hit and dedup rates, rounds with rows and buckets, the
   evidence verdicts, ms a height per chaos stage, the links' drops and
   duplicates, kernel 3's launches on vote rounds and the others); the
   launches add to the kernels line.
11. The verify service and the sequencer plane (``service_phase``): one
   ``ServiceThread`` on the card, with its own ``BatchVerifier``
   (``min_device_batch`` ``SERVICE_MIN_BATCH``), serves three clients over a
   Unix socket: two ``RemoteVerifyScheduler``s in this process and one in a
   child process that imports only the port (``SERVICE_CHILD``). (a) One
   commit of phase 3 alone (kernel 2 builds the service's tables, kernel 3
   verifies), then each client submits phase 3's commits at once and one of
   them a 39-commit window of phase 9's chain (one commit tampered by the
   heaviest third; kernels 5 and 6), raw and through
   ``verify_commits_light``: verdicts bit-identical to an in-proc
   ``VerifyScheduler``'s; the tenants, rounds against submissions, round
   trips (median, p99), PING round trips (the IPC alone) and a 150-row
   commit through the service against in-proc, in turns. (b) The service
   stopped with the three attached (inside 5 s, its thread dead), a
   submission while it is down on the client's own verifier on the card
   with the degrade event ``service unreachable``, a restart on the same
   path that every client re-attaches to. (c) The BFT -> sequencer upgrade
   of ``tests/torch_sequencer_net.py``: 3 validators over encrypted p2p,
   node 0 the sequencer, two followers, the process default scheduler a
   ``RemoteVerifyScheduler`` to the service; the votes before the upgrade
   on kernel 3 through the service, the followers' ``secp_recover`` rounds
   after it (on the service's host). Every round of the service's verifier
   held against the plain version, its kernel 2 and 5 tables against
   theirs; the launches add to the kernels line.
12. The event plane (``events_phase``): a joining node catches up with its
   events published, indexed and queryable. Phase 9's chain is blocksynced
   from one honest server over encrypted p2p (``catchup_sync``) by a fresh
   node whose app, the port's kvstore, runs in a child process started
   through the port's ABCI CLI (``EVENTS_APP``: ``abci.cli``'s ``kvstore``
   command) and is reached over the ABCI socket by a ``SocketClient``;
   its ``BlockExecutor`` publishes to an ``EventBus`` made on the sync's
   event loop, an ``IndexerService`` over a ``KVIndexer`` on a
   ``SqliteKV`` and three subscribers (every NewBlock, the txs past height
   ``EVENTS_TX_AFTER``, the key ``EVENTS_KEY``) drained while it syncs
   (``EventPlane``). Checks: the chain as in phase 9; 128 NewBlocks in
   order with the source's hashes, heights 101-128's 84 txs, one tx of
   the key; every one of the 384 txs from ``get_tx`` with its height and
   index, ``search_txs`` and ``search_blocks`` in the indexer's
   ``type.key=value`` form; the CLI's ``info`` (height 128, the app hash
   after it) and ``query``; every recorded round against its plain
   version and the host oracle (``check_recorded``). Prints the sync's
   wall beside phase 9 (a)'s, the publishes' and the indexer's shares of
   it, the socket app's share of ``apply_block``, the messages and the
   launches, which add to the kernels line. The node then goes to phase 13
   before its teardown; the child is killed at phase 13's end, pass or fail.
13. The operator plane (``operator_phase``): phase 12's node, with what
   ``tendermint_tpu/node/node.py`` wires beside its stores (a
   ``LightServePlane``, a ``HealthMonitor`` bound to the scheduler's
   metrics and ledger, the serving plane's metrics and the tracer, a
   ``ProfileCapture`` on cuda, a started ``VerifyScheduler`` as the process
   default), served by the port's ``RPCServer`` on 127.0.0.1. Over HTTP
   JSON-RPC: (a) ``profile_start`` with the device trace (a second start
   refused with -32000); a ``LightProxy``'s ``LightClient``, trusted at
   height 1 with an ``RPCProvider`` to the node as primary and another as
   witness, syncs 1 -> 128 sequentially through
   ``default_dispatch("light")``; a consumer reads commit, validators, block
   (every ``OPERATOR_STRIDE``-th height and the tip) and status through the
   proxy; ``OPERATOR_CLIENTS`` (64) ``RPCProvider`` clients skip 1 -> 128 at
   once; ``profile_stop``. (b) ``tx_search`` and ``tx`` on the indexer,
   ``abci_query`` and ``abci_info`` through the socket app, ``health``,
   ``dump_health``, ``dump_dispatch_ledger``, ``dump_traces``. Checks:
   every header, commit and validator set the proxy returns against the
   source chain; every recorded round against its plain version and the
   host oracle; the device trace on, its file there, its per-kernel
   launches (``TRACE_KERNELS``) equal to the phase's counts; the loop
   profile's samples; the ledger route's rounds against the ledger's;
   ``tx_search`` against the indexer's ``search_txs``. Prints the proxy's
   ms a step beside catch-up (c)'s, the clients' wall and rounds, the
   trace's per-kernel split (``cudaLaunchKernel``, queue gap, device time),
   the loop profile's top stacks, the health roll-up and the launches,
   which add to the kernels line.
14. The assembled node (``node_phase``, ``testnet_phase``), each part a
   child process of the port's CLI. (a) A home holds phase 9's genesis,
   ``[scheduler] prewarm = true``, the RPC and the debug server on free
   ports and two ``BlocksyncReactor`` peers serving phase 9's chain (on this
   process's event loop, beside a reactor that drops the channels a full
   node speaks besides blocksync) as persistent peers; ``python -X
   importtime -m tendermint_tpu_torch --home H start --device cuda`` loads
   the kernels from the build cache (its log's ``cuda kernels`` line:
   reused), warms the 150 keys, prewarms the ladder, blocksyncs 128 heights
   and switches to consensus. Polled over its RPC without blocking the
   loop: every block hash, commit and app hash against phase 9's; its
   rounds from ``dump_dispatch_ledger``; its launches per kernel from
   ``/debug/torch/launches`` (added to the kernels line, and each row's
   ``node_launches``); ``python -m tendermint_tpu_torch.tools.prewarm
   --verify`` on its manifest; SIGINT: exit 0 inside ``NODE_STOP_S``.
   Prints its boot (torch's import, the kernels' load), warm and sync walls
   beside phase 9 (a)'s. (b) ``testnet --v 4`` (ports rewritten), one
   ``verify-service --device cuda`` child and four ``start --device cuda``
   children on the card, every ``[scheduler] remote_socket`` the
   service's: all reach height 3 with equal height-2 block hashes, no child
   builds the kernels, the service's rounds merged across its tenants (and
   those under ``min_device_batch``); SIGINT: all five exit 0. The chain of
   phase 9 is built, and its syncing nodes start, with the app's InitChain
   through the ``Handshaker``, as a node's does, so the CLI's node syncs it.
15. The harnesses (``harness_phase``): the port's ``tools/`` at their own
   sizes. (a) ``verify_service_bench.run_family`` at 4, 32 and 100
   validators (``HARNESS_SIZES``), 2 warm and 2 measured heights, up to 8
   worker processes a size, the service's rounds capped at 16,384: one
   ``python -m tendermint_tpu_torch verify-service --device cuda`` child a
   size owns the card, and each worker's nodes submit per height n real
   ed25519 vote rows and one n-signer BLS group through their own
   ``RemoteVerifyScheduler``. Checks: every size without error, real
   signatures, zero degrades; while it runs (``CardHolders``) nvidia-smi's
   compute apps list the smoke and the service child and no worker, and
   no worker holds a ``/dev/nvidia*`` file. Prints per size the wall a
   height, requests per dispatch, the IPC round trip and the service
   ledger's rounds by tier and bucket (the child's launches are not
   counted). (b) ``qc_bench.run_qc_catchup`` at its defaults (4, 32, 100
   validators, 8 blocks) on the native pairing and on the card's
   (``TM_TPU_BLS_PAIRING_DEVICE=1``): ms a block of the baseline and the QC
   window, flatness, growth, proof compression. (c) ``bench_replay``, 64
   commits x 128 validators, ``--device cuda``, in this process: windowed
   and per-block sigs/s. (d) ``soak --iters 1 --device cuda`` as a child,
   seed ``SOAK_SEED``: ``ok`` and its heights. (b) and (c) count launches,
   added to the kernels line and each row's ``harness_launches``; the tools
   assert every verdict.

Then the ``time:`` walls per phase, the ``kernels`` JSON line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Without CUDA it exits non-zero before printing any result. The full
ptxas report is kept beside the build, in
``tendermint_tpu_torch/_kbuild/ptxas_report.txt``.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import gc
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit integer
# multiply-adds/s, taken as a quarter of the 67 TFLOP/s float32 rate
# (IMAD issues at half the FFMA rate, and an FFMA counts two FLOPs). The
# SHA-512 kernel's logic, shift and add instructions are counted against
# the same rate.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
# a 5 x 51-bit field multiply is 25 64x64->128-bit products, each four
# 32x32-bit multiply-adds
IMAD_PER_FE_MUL = 25 * 4

# field multiplications per row, counted from ops/csrc/ed25519_kernels.cu
FE_INVERT = 265
FE_POW22523 = 262
FE_DECOMPRESS = 13 + FE_POW22523
FE_TABLE_BUILD = 1 + 14 * 8 + 16  # to_cached(A), 14 cached adds, 16 to_cached
# one key of the four-lane kernel 2: the decompression (every lane alike),
# to_cached(-A), 14 cached adds of 2, 16 to_cached
FE_TABLE_PATH = FE_DECOMPRESS + 1 + 14 * 2 + 16
FE_VAR_MULT = 64 * (4 * 8 + 8)  # 64 windows of 4 doublings + 1 cached add
FE_BASE_MULT = 32 * 8
FE_FINISH = 1 + 8 + FE_INVERT + 2  # to_cached, add, compress
FE_VERIFY_TABLE = FE_VAR_MULT + FE_BASE_MULT + FE_FINISH
# the dependent multiplications of one row of the four-lane kernel 3: 2 a
# point operation (64 x 5 in [k](-A), 32 in [s]B, 1 in the finish), and
# the finish's to_cached, inversion and two products
FE_VERIFY_TABLE_PATH = 2 * (64 * 5 + 32 + 1) + 1 + FE_INVERT + 2
FE_VERIFY_GENERIC = FE_DECOMPRESS + FE_TABLE_BUILD + FE_VERIFY_TABLE
# one row of the four-lane kernel 4: the decompression (every lane alike),
# to_cached(-A), the table's 14 cached adds of 2, the last entry's
# to_cached, then kernel 3's chain
FE_VERIFY_GENERIC_PATH = FE_DECOMPRESS + 1 + 14 * 2 + 1 + FE_VERIFY_TABLE_PATH
FE_DBL = 8
# a doubling on the four lanes of kernel 1 (ge_dbl_x4): two stages of 4
# independent multiplications
FE_DBL_PATH = 2
# a doubling of the one-thread chain (ge_dbl) in 32-bit instructions as
# nvcc compiles it: the SASS of the one-thread dbl_chain_kernel's rolled
# loop (chip_kernels.py --kernel 1 with that kernel's tree as --parent,
# "kernel1 sass:"), 641 of them the IMAD.WIDE of the 160 64x64-bit
# products (FE_DBL x IMAD_PER_FE_MUL = 800 counts those alone, the four
# squarings at 25 products); every 32-bit integer instruction issues at
# the IMAD rate, so kernel 1's bound counts them all, as kernels 8's and
# 9's do
DBL_OPS = 2047
# the big table of one key: decompress, to_cached(-A), 14 cached adds for
# row 0, 63 x 4 doublings of the 16 columns, 64 x 16 to_cached (the work
# of the function; the kernel's 16 threads per key each decompress and
# repeat row 0's adds up to their column)
FE_BIGTABLE = FE_DECOMPRESS + 1 + 14 * 8 + 63 * 4 * 16 * FE_DBL + 64 * 16
FE_VERIFY_BIG = 64 * 8 + FE_BASE_MULT + FE_FINISH  # 64 cached adds, [s]B
# the dependent multiplications of one row of the four-lane kernel 6: the
# 32 base adds ride in one pass with the first 32 window adds, so 64 point
# operations of 2, then the finish (to_cached, one add, inversion, two)
FE_VERIFY_BIG_PATH = 2 * 64 + 1 + 2 + FE_INVERT + 2
# the chain of one (key, column) of the big table: on one thread,
# decompress, to_cached(-A), 14 cached adds (column 15), 64 to_cached and
# 63 x 4 doublings; with four lanes, 2 a point operation and 1 a to_cached
FE_BIGTABLE_THREAD = FE_DECOMPRESS + 1 + 14 * 8 + 64 + 63 * 4 * FE_DBL
FE_BIGTABLE_PATH = FE_DECOMPRESS + 14 * 2 + 64 + 63 * 4 * 2
# SHA-512, per 128-byte block, in 32-bit instructions as nvcc compiles
# ops/csrc/sha512_device.cuh (LOP3 and IADD3 take three inputs, a 64-bit
# rotation is two SHF): 80 rounds of 45 with the schedule step (SASS of
# challenge_kernel, the full build less the rounds-emptied build, over
# 80: chip_kernels.py --kernel 8, "kernel8 sass:"), the 32 PRMT of the
# byte swaps and the 16 IADD3 of the feed-forward
SHA512_OPS_PER_BLOCK = 80 * 45 + 32 + 16
# sc_reduce with the digest's bytes, per row: the full build less the
# reduce-emptied build ("kernel8 sass:"; straight-line code, so its static
# count is the count it runs)
SC_REDUCE_OPS = 768

# commits per blocksync window (VERIFY_WINDOW, tendermint_tpu/blocksync/
# reactor.py:243): the bulk path verifies one window as one batch
WINDOW = 64

# the in-process consensus net: the live size of the JAX package's
# committee_scale sweep (bench.py, _run_committee_net), and the heights
# each mode commits past the first (1, cut from 3 so that phase 15's
# harnesses fit the script's 1200-second limit on a slow host)
NET_VALIDATORS = 32
NET_HEIGHTS = 1
# mode (c)'s topology: past 8 nodes each node dials its next NET_PEER_DEGREE
# ring successors (the JAX package's committee net: bench.py's degree rule,
# tests/torch_chaos_harness.ring_peer_indices), about 2 x NET_PEER_DEGREE
# encrypted connections a node
NET_PEER_DEGREE = 4
# phase 7's modes: (label, quorum certificates, over p2p)
NET_MODES = (("legacy", False, False), ("qc", True, False), ("p2p", False, True))

SOURCE = "tendermint_tpu_torch/ops/csrc/ed25519_kernels.cu"
SHA_SOURCE = "tendermint_tpu_torch/ops/csrc/sha512_kernels.cu"

# kernel 3's shapes, (rows, padding rows): one row group; a partial last
# warp with padding (a LastCommit round of the 32-validator net is 22-23
# rows); the commit path's 150 live rows alone and padded to its 256 bucket
KERNEL3_SIZES = ((1, 0), (23, 2), (150, 0), (256, 106))
# kernel 2's key counts: one group; a partial last warp; the commit path's
# 150 validators; the 256 keys of phase 2
KERNEL2_SIZES = (1, 23, 150, 256)
# kernel 8's batch whose last warp is partial: the first rows of the 2048
KERNEL8_PARTIAL = 1000
# kernel 9's partial last warp (rows of the L2 block's leaf batch) and
# kernel 1's (points of the 8,192)
KERNEL9_PARTIAL = 1000
KERNEL1_PARTIAL = 150
KERNEL3_BUCKETS = (8, 32, 128, 256)
# verify_commit at 150 validators, ms a height after the first, with the
# one-thread kernel 3 (PERF.md section 5; NVIDIA H100 80GB HBM3, 700 W)
COMMIT_MS_ONE_THREAD = (5.67, 5.74)


def kernel2_key_sets(torch, pub_d, n_valid: int) -> dict:
    """{n: (the first n keys of an order, their indices in pub_d)} for
    KERNEL2_SIZES: a valid key, then the adversarial keys and random bytes
    after the first n_valid, then the other valid keys; so 23 and 150 keys
    hold adversarial keys and keys with no square root inside warps of
    valid ones."""
    n = pub_d.shape[0]
    order = [0] + list(range(n_valid, n)) + list(range(1, n_valid))
    return {k: (pub_d[torch.tensor(order[:k], device=pub_d.device)], order[:k])
            for k in KERNEL2_SIZES}


def max_abs_err(a, b) -> int:
    """Largest elementwise difference of two integer/bool tensors."""
    return int((a.to(b.device).long() - b.long()).abs().max())


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def kernel_name(mangled: str) -> str:
    """The `*_kernel` identifier inside a mangled name: the shortest one
    whose length prefix reads exactly its characters (an anonymous
    namespace puts the file's name and a hash before it, and a run of the
    hash's digits can read as the length of a longer span that also ends
    in `_kernel`)."""
    names = []
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):
            n = int(m.group()[k:])
            name = mangled[m.end() : m.end() + n]
            if len(name) == n and re.fullmatch(r"[a-z]\w*_kernel", name):
                names.append(name)
    return min(names, key=len) if names else mangled


def ptxas_usage(report: str) -> dict[str, str]:
    """kernel name -> its stack/spill and register lines of -Xptxas -v."""
    usage: dict[str, list[str]] = {}
    name = None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = kernel_name(m.group(1))
            usage[name] = []
        elif name and ("spill" in ln or "Used" in ln):
            usage[name].append(ln.replace("ptxas info    :", "").strip())
            if "Used" in ln:
                name = None
    return {k: "; ".join(v) for k, v in usage.items()}


def bound_ms(nbytes: int, imads: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_cuda(torch, fn, reps: int) -> float:
    """Median ms of `reps` calls, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_once(torch, fn, *args):
    """(result, ms) of one call fn(*args) between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def mixed_rows(host, keys, pubs, n_rows: int, n_pad: int, tag: bytes):
    """n_rows (pubkey, msg, sig) rows over the keys: valid, wrong message,
    flipped signature bit, s >= L, adversarial keys (rows 200.. of pubs),
    and the last n_pad rows padding. Returns (items, idx, want) with
    idx -1 on padding rows and want the host oracle's verdicts."""
    n_keys = len(keys)
    items, idx = [], []
    for i in range(n_rows):
        ki = i % n_keys
        msg = b"%s-%d" % (tag, i)
        sig = keys[ki].sign(msg)
        kind = i % 8
        pub = pubs[ki]
        if kind == 1:
            msg = msg + b"!"
        elif kind == 2:
            sig = sig[:7] + bytes([sig[7] ^ 4]) + sig[8:]
        elif kind == 3:
            s = int.from_bytes(sig[32:], "little") + host.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == 4:
            ki = n_keys + (i // 8) % (len(pubs) - n_keys)
            pub = pubs[ki]
        items.append((pub, msg, sig))
        idx.append(-1 if i >= n_rows - n_pad else ki)
    want = [
        host.verify(p, m, s) and i < n_rows - n_pad
        for i, (p, m, s) in enumerate(items)
    ]
    return items, idx, want


def row_tensors(torch, host, items, idx, n_pad: int, dev):
    """R, S, K (host challenges), s_ok (False on the last n_pad rows) and
    idx as int32 of (pubkey, msg, sig) rows, on dev."""
    def T(rows):
        return torch.tensor([list(r) for r in rows], dtype=torch.uint8, device=dev)

    R = T([sg[:32] for _, _, sg in items])
    S = T([sg[32:] for _, _, sg in items])
    K = T([host.challenge(sg[:32], p, m).to_bytes(32, "little") for p, m, sg in items])
    ok = torch.tensor([int.from_bytes(sg[32:], "little") < host.L for _, _, sg in items])
    ok[len(items) - n_pad:] = False
    return R, S, K, ok.to(dev), torch.tensor(idx, dtype=torch.int32, device=dev)


def kernel3_rows(torch, host, keys, pubs, tables, tvalid, b: int, n_pad: int,
                 tag: bytes):
    """Kernel 3's operands for b rows of mixed_rows over a table store of
    pubs on the card, the last n_pad padding; rows 3 and 9, where live,
    get idx -1 and idx past the store, inside warps of live rows (a warp
    holds 8 row groups of 4 lanes). Returns (operands, the host oracle's
    verdicts)."""
    items, idx, want = mixed_rows(host, keys, pubs, b, n_pad, tag)
    for row, v in ((3, -1), (9, tables.shape[0] + 5)):
        if row < b - n_pad:
            idx[row], want[row] = v, False
    R, S, K, ok, idx_t = row_tensors(torch, host, items, idx, n_pad, tables.device)
    return (tables, tvalid, idx_t, R, S, K, ok), want


def kernel4_rows(torch, host, keys, pubs, b: int, n_pad: int, tag: bytes, dev):
    """Kernel 4's operands (pubkeys, R, S, K, s_ok) for b rows of
    mixed_rows on dev, the last n_pad padding (zero rows, s_ok False, as
    the bucket pads); where live, row 3 is such a padding row and row 8
    keeps its valid signature under s_ok False, inside warps of live rows
    (a warp holds 8 row groups of 4 lanes). Returns (operands, the host
    oracle's verdicts)."""
    items, idx, want = mixed_rows(host, keys, pubs, b, n_pad, tag)
    pad = list(range(b - n_pad, b)) + ([3] if 3 < b - n_pad else [])
    for i in pad:
        items[i], want[i] = (bytes(32), b"", bytes(64)), False
    R, S, K, ok, _ = row_tensors(torch, host, items, idx, n_pad, dev)
    K[pad] = 0
    ok[pad] = False
    if 8 < b - n_pad:
        assert want[8], "row 8 is a valid signature"
        ok[8], want[8] = False, False
    pub = torch.tensor([list(p) for p, _, _ in items], dtype=torch.uint8, device=dev)
    return (pub, R, S, K, ok), want


def heaviest_third(vset) -> list[int]:
    """Indices of the heaviest validators holding more than 1/3 of the
    power (signed_window's choice)."""
    vals = vset.validators
    total = sum(v.voting_power for v in vals)
    out, power = [], 0
    for i in sorted(range(len(vals)), key=lambda i: -vals[i].voting_power):
        if 3 * power > total:
            break
        out.append(i)
        power += vals[i].voting_power
    return out


def signed_window(host, types, vset, by_addr, chain_id, n_commits, bad_height, rng):
    """n_commits commits of vset for heights 1.., all validators signing
    for the block; at bad_height the signatures of the heaviest
    validators holding more than 1/3 of the power are tampered. Returns
    (entries [(block_id, height, commit)], tampered validator indices)."""
    vals = vset.validators
    tampered = heaviest_third(vset)
    entries = []
    for h in range(1, n_commits + 1):
        bid = types.BlockID(
            hash=rng.bytes(32),
            part_set_header=types.PartSetHeader(total=1, hash=rng.bytes(32)),
        )
        sigs = [
            types.CommitSig(types.BlockIDFlag.COMMIT, v.address,
                            1_700_000_000_000_000_000 + h * 10**9 + i)
            for i, v in enumerate(vals)
        ]
        commit = types.Commit(h, 0, bid, sigs)
        for i, v in enumerate(vals):
            sig = by_addr[v.address].sign(commit.vote_sign_bytes(chain_id, i))
            if h == bad_height and i in tampered:
                sig = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
            sigs[i].signature = sig
        entries.append((bid, h, commit))
    return entries, tampered


def run_window(verifier, vset, chain_id, entries, reps: int, label: str,
               metrics=None):
    """verify_commits_light over the window, `reps` times, from an executor
    thread through a started VerifyScheduler installed as the process
    default (default_dispatch("blocksync")), as blocksync's reactor does;
    then the window's rows once more through the same adapter for the
    per-row bitmap. Each timed window starts after a full garbage
    collection, and the collector's pauses inside it are summed. Returns
    (verdicts per rep, wall seconds per rep, gc pause seconds per rep,
    bitmap, items, the scheduler's ledger entries). `metrics` (a
    SchedulerMetrics) is the scheduler's, one of its own when None."""
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import (
        VerifyScheduler, default_dispatch, set_default_scheduler,
    )

    items = [
        it for _, _, c in entries for it in vset._gather_items(chain_id, c, True)[0]
    ]
    ledger = DispatchLedger()
    sched = VerifyScheduler(
        verifier=verifier, ledger=ledger,
        metrics=metrics or SchedulerMetrics(Registry("smoke_" + label)),
    )

    gc_pause = [0.0, 0.0]  # summed seconds, start of the current pause

    def on_gc(phase, info):
        if phase == "start":
            gc_pause[1] = time.perf_counter()
        else:
            gc_pause[0] += time.perf_counter() - gc_pause[1]

    async def go():
        await sched.start()
        loop = asyncio.get_running_loop()
        verdicts, walls, gcs = [], [], []
        try:
            for _ in range(reps):
                gc.collect()
                gc_pause[0] = 0.0
                t0 = time.perf_counter()
                verdicts.append(await loop.run_in_executor(
                    None,
                    lambda: vset.verify_commits_light(
                        chain_id, entries, verifier=default_dispatch("blocksync")
                    ),
                ))
                walls.append(time.perf_counter() - t0)
                gcs.append(gc_pause[0])
            bitmap = await loop.run_in_executor(
                None, lambda: default_dispatch("blocksync").verify(items)
            )
        finally:
            await sched.stop()
        return verdicts, walls, gcs, bitmap

    set_default_scheduler(sched)
    gc.callbacks.append(on_gc)
    try:
        verdicts, walls, gcs, bitmap = asyncio.run(go())
    finally:
        gc.callbacks.remove(on_gc)
        set_default_scheduler(None)
    return (verdicts, walls, gcs, [bool(v) for v in bitmap], items,
            ledger.entries())


def check_window(host, verdicts, bitmap, items, entries_ledger, n_commits,
                 bad_height, tampered, n_vals, rng, label):
    """The contract of one bulk run: verdicts, the per-row bitmap False
    exactly on the tampered rows, a seeded sample against the host oracle,
    and every ledger round one blocksync round of the whole window."""
    want = [h != bad_height for h in range(1, n_commits + 1)]
    for v in verdicts:
        assert v == want, f"{label}: verdicts {v}"
    bad_rows = {(bad_height - 1) * n_vals + i for i in tampered}
    assert [i for i, ok in enumerate(bitmap) if not ok] == sorted(bad_rows), label
    for i in rng.choice(len(items), size=min(256, len(items)), replace=False):
        it = items[int(i)]
        assert bitmap[int(i)] == host.verify(it.pubkey, it.msg, it.sig), (label, i)
    for e in entries_ledger:
        assert e["engine"] == "sig" and e["rows"] == {"blocksync": len(items)}, e


# --- the quorum-certificate path (BLS12-381) --------------------------------

BLS_SOURCE = "tendermint_tpu_torch/ops/csrc/bls_kernels.cu"
# an Fp multiplication of bls12_381_device.cuh: Montgomery CIOS over 6 x
# 64-bit limbs, 72 64x64->128-bit products of four 32-bit multiply-adds
IMAD_PER_FP_MUL = 72 * 4
# Fp multiplications per operation, counted from bls12_381_device.cuh
FP_G1_ADD = 16
FP_G2_ADD = 5 * 2 + 11 * 3  # 5 Fp2 squarings, 11 Fp2 multiplications
FP_F12_MUL, FP_F12_SQR, FP_LINE = 54, 36, 54
FP_MILLER_DBL, FP_MILLER_ADD = 31, 43
FP_INV = 381 + 229  # Fermat: the bits and the set bits of p - 2
FP_CYCLO_SQR, FP_FROB = 18, 18
FP_EXP_X = 64 * FP_CYCLO_SQR + 6 * FP_F12_MUL
FP_F12_INV = 2 * FP_F12_MUL + 37 + FP_INV
FP_FINAL_EXP = (2 * FP_F12_MUL + FP_F12_INV + 2 * FP_FROB  # easy part
                + 5 * FP_EXP_X + 7 * FP_F12_MUL + FP_CYCLO_SQR + 3 * FP_FROB
                + 12 + 12 + 12)  # loads, stores, the gamma table
MILLER_BITS = 63  # bits of |x| after the leading one
MILLER_ADDS = 5  # set bits of |x| after the leading one
# the dependent Fp multiplications of one 2-pair chunk on one thread (the
# parent's miller_kernel): per bit an f12 squaring and each pair's doubling
# step and line product, per set bit each pair's addition step and line
# product, the loads and the store
FP_MILLER_THREAD = (MILLER_BITS * (FP_F12_SQR + 2 * (FP_MILLER_DBL + FP_LINE))
                    + MILLER_ADDS * 2 * (FP_MILLER_ADD + FP_LINE) + 12 + 12)
# the critical paths of the warp kernels, in dependent Fp multiplications:
# the longest path of each stage program (python -m
# tendermint_tpu_torch.ops.bls_warp_gen prints them), a load and a store of
# one multiplication each. Miller: a doubling bit is 5 (the doubling step's
# 3 product levels, the two lines' product, f^2 times it; f's squaring
# runs beside the steps), an addition bit 8; the chunk product adds one a
# level. Final exponentiation: the easy part 12 (its inversion, a binary
# extended Euclid on one lane, counts its one multiplication; its
# halvings and subtractions are not multiplications), a^x 64 cyclotomic
# squarings and 6 products of 1, the glue between the five a^x 1, 1, 2, 0
# and 5.
FP_MILLER_DBL_PATH, FP_MILLER_ADD_PATH = 5, 8
FP_MILLER_PATH = (1 + (MILLER_BITS - MILLER_ADDS) * FP_MILLER_DBL_PATH
                  + MILLER_ADDS * FP_MILLER_ADD_PATH + 1)
FP_EASY_PATH, FP_EXP_X_PATH, FP_GLUE_PATH = 12, 64 + 6, 1 + 1 + 2 + 0 + 5
FP_FINAL_EXP_PATH = 1 + FP_EASY_PATH + 5 * FP_EXP_X_PATH + FP_GLUE_PATH + 1
# the G2 sums on a warp (g2_add_w): the dependent Fp multiplications of an
# addition are its product stages, 2 of G2_HR and 3 of G2_ADD_FIN; of a
# doubling (G2_DBL) 3 (python -m tendermint_tpu_torch.ops.bls_warp_gen)
FP_G2_ADD_PATH, FP_G2_DBL_PATH = 5, 3
# tm_g2_add on one pair: on one thread (the parent's g2_add_kernel) 12
# loads, the addition and 6 stores in series; on a warp one load and one
# store a lane
FP_G2_ADD_THREAD = 12 + FP_G2_ADD + 6
FP_G2_ADD_KERNEL_PATH = 1 + FP_G2_ADD_PATH + 1
G2_TREE_WARPS = 16  # kG2TreeWarps of bls_kernels.cu: a G2 tree's warps, at most
# the G1 sums on lane groups (g1_add_g): an addition's product stages, 2 of
# G1_HR and 3 of G1_ADD_FIN; a doubling's (G1_DBL) 3
FP_G1_ADD_PATH, FP_G1_DBL_PATH = 5, 3
# kG1TreeLanes, kG1AddLanes and kG1TreeWarps of bls_kernels.cu: the lanes
# of a G1 tree addition's group and of a pair sum's, a G1 tree's warps of
# groups, at most
G1_TREE_LANES, G1_ADD_LANES, G1_TREE_WARPS = 4, 8, 16
# tm_g1_add on one pair: on one thread (the parent's g1_add_kernel) 6 loads,
# the addition and 3 stores in series; on a group the 6 loads spread over
# its lanes and one store a lane
FP_G1_ADD_THREAD = 6 + FP_G1_ADD + 3
FP_G1_ADD_KERNEL_PATH = -(-6 // G1_ADD_LANES) + FP_G1_ADD_PATH + 1
# the one-thread trees' threads, at most (the parents' G1 and G2 sums)
TREE_THREADS = 128


def g2_tree_paths(b: int) -> tuple[int, int]:
    """Dependent Fp multiplications of tm_g2_aggregate on one tree of b
    keys, (one thread an addition, a warp an addition): the leaf loads a
    thread runs in series, each level's addition, the store."""
    nb = 1 << max(1, (b - 1).bit_length())
    levels = nb.bit_length() - 1
    threads = min(TREE_THREADS, nb // 2)
    warps = min(G2_TREE_WARPS, nb // 2)
    return (6 * -(-b // threads) + levels * FP_G2_ADD + 6,
            -(-6 * b // (32 * warps)) + levels * FP_G2_ADD_PATH + 1)


def g1_tree_paths(b: int) -> tuple[int, int]:
    """Dependent Fp multiplications of tm_g1_aggregate on one tree of b
    signatures, (one thread an addition, a lane group an addition): the
    leaf loads a thread runs in series, each level's additions (on groups,
    in as many rounds as a level has additions per group), the store."""
    nb = 1 << max(1, (b - 1).bit_length())
    levels = nb.bit_length() - 1
    threads = min(TREE_THREADS, nb // 2)
    groups = min(G1_TREE_WARPS * 32 // G1_TREE_LANES, nb // 2)
    rounds = sum(-(-(nb >> k) // groups) for k in range(1, levels + 1))
    return (3 * -(-b // threads) + levels * FP_G1_ADD + 3,
            -(-3 * b // (G1_TREE_LANES * groups)) + rounds * FP_G1_ADD_PATH + 1)


QC_BAD = 40  # the forged certificate's height in the 64-QC window


def miller_fp_muls(n_valid: int) -> int:
    """Fp multiplications of tm_miller that this data needs: each valid
    pair's loads, doubling/addition steps and line products, the f12
    squarings of each chunk that holds a valid pair, the product of those
    chunks and the store. Padding pairs and chunks (their value stays one)
    count nothing."""
    chunks = -(-n_valid // 2)
    per_pair = (6 + MILLER_BITS * (FP_MILLER_DBL + FP_LINE)
                + MILLER_ADDS * (FP_MILLER_ADD + FP_LINE))
    return (n_valid * per_pair + chunks * MILLER_BITS * FP_F12_SQR
            + (chunks - 1) * FP_F12_MUL + 12)


def f12_pow(c, a, e: int):
    r = c.F12_ONE
    for bit in bin(e)[2:]:
        r = c.f12_mul(r, r)
        if bit == "1":
            r = c.f12_mul(r, a)
    return r


def timed(module, names, acc):
    """Wrap module functions (or an object's methods) with host timers
    summed into acc[name]; returns the originals for restore()."""
    saved = {}
    for name in names:
        fn = getattr(module, name)
        saved[name] = fn

        def wrap(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc[_name] = acc.get(_name, 0.0) + time.perf_counter() - t0

        setattr(module, name, wrap)
    return saved


def timed_async(cls, name, acc):
    """timed() for one coroutine method: its wall per call, awaits
    included, summed into acc[name]; returns the original for restore()."""
    fn = getattr(cls, name)

    async def wrap(*a, **k):
        t0 = time.perf_counter()
        try:
            return await fn(*a, **k)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

    setattr(cls, name, wrap)
    return {name: fn}


def restore(module, saved):
    for name, fn in saved.items():
        if hasattr(fn, "__func__") and fn.__self__ is module:
            delattr(module, name)  # a bound method: drop the instance's wrapper
        else:
            setattr(module, name, fn)


BLS_GATE = "TM_TPU_BLS_PAIRING_DEVICE"


def qc_route(torch, ops, bls, qcm, qset, vals, privs, chain_id, entries,
             split_names, device):
    """One BLS route of the QC path: assemble_qc over the window's commits
    (launch counts read), QC QC_BAD replaced by a sub-quorum aggregate
    under the full bitset, then verify_commits_qc over the window from an
    executor thread through a started VerifyScheduler's qc_verify lane,
    twice (launch counts read). With `device`, each QC's signature sum and
    signer-key sum also go through the named device sums, held against
    the assembled (native) ones, each call timed on the host clock (parse
    of the points, copies, the kernel, the result's bytes) into
    ``sums_s``."""
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler

    ops.reset_launches()
    t0 = time.perf_counter()
    qcs = [qcm.assemble_qc(chain_id, commit, qset) for _, _, commit in entries]
    assemble_s = time.perf_counter() - t0
    assert all(q is not None and q.num_signers() == len(vals) for q in qcs)
    sums_s = {"g1": 0.0, "g2": 0.0}
    if device:
        for q, (_, _, commit) in zip(qcs, entries):
            shares = [bls.g1_from_bytes(commit.signatures[i].qc_signature)
                      for i in q.signers.ones()]
            t0 = time.perf_counter()
            got = bls.g1_to_bytes(bls.aggregate_signatures_device(shares))
            sums_s["g1"] += time.perf_counter() - t0
            assert got == q.agg_signature, "aggregate_signatures_device != native"
            keys = [bls.new_trusted_public_key(
                bls.g2_from_bytes(qset.validators[i].bls_pub_key))
                for i in q.signers.ones()]
            t0 = time.perf_counter()
            got = bls.g2_to_bytes(bls.aggregate_public_keys_device(keys))
            sums_s["g2"] += time.perf_counter() - t0
            assert got == bls.g2_to_bytes(bls.aggregate_public_keys(keys).key), \
                "aggregate_public_keys_device != native"
    torch.cuda.synchronize()
    asm_launches = ops.kernel_launches()
    bad = qcm.QuorumCertificate.decode(qcs[QC_BAD - 1].encode())
    hm = bls.hash_to_g1(bad.sign_bytes(chain_id))
    shares = [bls._g1_mul_point(hm, privs[v.address]) for v in vals[: len(vals) // 2]]
    bad.agg_signature = bls.g1_to_bytes(bls.aggregate_signatures(shares))
    window = [(bid, h, q) for (bid, h, _), q in zip(entries, qcs)]
    window[QC_BAD - 1] = (window[QC_BAD - 1][0], QC_BAD, bad)

    ledger = DispatchLedger()
    sched = VerifyScheduler(ledger=ledger, metrics=SchedulerMetrics(
        Registry(f"smoke_qc_{int(device)}")))
    splits, walls = [], []

    async def go():
        await sched.start()
        loop = asyncio.get_running_loop()
        out = []
        try:
            for _ in range(2):
                acc = {}
                saved = timed(bls, split_names, acc)
                try:
                    gc.collect()
                    t0 = time.perf_counter()
                    out.append(await loop.run_in_executor(
                        None, lambda: qset.verify_commits_qc(chain_id, window)))
                    walls.append(time.perf_counter() - t0)
                finally:
                    restore(bls, saved)
                splits.append(acc)
        finally:
            await sched.stop()
        return out

    ops.reset_launches()
    set_default_scheduler(sched)
    try:
        verdicts = asyncio.run(go())
    finally:
        set_default_scheduler(None)
    torch.cuda.synchronize()
    return {
        "qcs": qcs, "assemble_s": assemble_s, "sums_s": sums_s,
        "asm_launches": asm_launches,
        "verdicts": verdicts, "walls": walls, "splits": splits,
        "win_launches": ops.kernel_launches(),
        "rounds": [e for e in ledger.entries() if e["engine"] == "qc_verify"],
    }


def qc_keys(types, bls, qcm, vset, chain_id, entries, scalar, g2):
    """BLS keys for the validators of vset and QC signature shares on every
    commit of the window: four keys through pubkey_from_priv (proof of
    possession, one native pairing each), the rest trusted keys, as a
    genesis file carries them. Returns (qset, vals, privs, pubs)."""
    vals = vset.validators
    privs = {v.address: scalar() for v in vals}
    pubs = {}
    for i, v in enumerate(vals):
        k = privs[v.address]
        pubs[v.address] = (bls.pubkey_from_priv(k) if i < 4 else
                           bls.new_trusted_public_key(g2(k))).key
    qset = types.ValidatorSet([
        types.Validator(v.pub_key, v.voting_power, bls_pub_key=bls.g2_to_bytes(pubs[v.address]))
        for v in vals
    ])
    assert [v.address for v in qset.validators] == [v.address for v in vals]
    for h, (bid, _, commit) in enumerate(entries, start=1):
        hm = bls.hash_to_g1(qcm.qc_sign_bytes(chain_id, h, 0, bid))
        for cs, v in zip(commit.signatures, vals):
            cs.qc_signature = bls.g1_to_bytes(bls._g1_mul_point(hm, privs[v.address]))
    return qset, vals, privs, pubs


def pairing_operands(torch, rng, dev):
    """Adversarial operands of miller and final_exp, which the plain
    versions must match byte for byte: coordinates and Fp12 limbs that are
    0, 1, p - 1, p, p + 1, 2^384 - 1, random values >= p (all read mod p)
    and random values below p, so no point is on its curve. Miller: 4
    chunks (both pairs valid; pair 1 invalid; both invalid; both valid with
    every coordinate 0), then one all-invalid chunk alone. final_exp: the
    zero element, one, every limb p - 1, every limb 2^384 - 1, and two of
    mixed special and random limbs. Returns ([chunk tuples], [N, 6, 2, 48])."""
    from tendermint_tpu_torch.crypto import bls12_381 as c

    special = [0, 1, c.P - 1, c.P, c.P + 1, (1 << 384) - 1]

    def value() -> int:
        k = int(rng.integers(0, len(special) + 2))
        if k < len(special):
            return special[k]
        if k == len(special):
            return c.P + int.from_bytes(rng.bytes(48), "little") % ((1 << 384) - c.P)
        return int.from_bytes(rng.bytes(48), "little") % c.P

    def t(vals, *shape):
        raw = [list(v.to_bytes(48, "little")) for v in vals]
        return torch.tensor(raw, dtype=torch.uint8).reshape(*shape, 48).to(dev)

    def chunks(valid, zero=()):
        n = len(valid)
        coords = [[0 if k in zero else value() for _ in range(12)] for k in range(n)]
        xp = t([v for cc in coords for v in cc[0:2]], n, 2)
        yp = t([v for cc in coords for v in cc[2:4]], n, 2)
        xq = t([v for cc in coords for v in cc[4:8]], n, 2, 2)
        yq = t([v for cc in coords for v in cc[8:12]], n, 2, 2)
        return xp, yp, xq, yq, torch.tensor(valid, dtype=torch.bool).to(dev)

    miller_ops = [
        chunks([[True, True], [True, False], [False, False], [True, True]], zero=(3,)),
        chunks([[False, False]]),
    ]
    rows = [[0] * 12, [1] + [0] * 11, [c.P - 1] * 12, [(1 << 384) - 1] * 12,
            [value() for _ in range(12)], [value() for _ in range(12)]]
    f12 = t([v for r in rows for v in r], len(rows), 6, 2)
    return miller_ops, f12


def qc_phase(torch, rng, dev, smi, ops, types, vset, chain_id, entries):
    """Phase 5: BLS kernels against their plain versions and the oracle,
    then a 64-QC window over the 150-validator set: proposer-side assembly
    (assemble_qc) and verify_commits_qc through a started VerifyScheduler's
    qc_verify lane, twice. Returns the four kernels' rows, for the mesh
    phase the point sets {"g1"|"g2": [(label, points, host points)]}, and
    the pairing kernels' and the trees' ms {"miller_verify",
    "miller_rlc", "final_exp", "g1_aggregate", "g1_forest", "g2_aggregate",
    "g2_forest"}."""
    from tendermint_tpu_torch.crypto import bls12_381 as c
    from tendermint_tpu_torch.crypto import bls_native
    from tendermint_tpu_torch.crypto import bls_signatures as bls
    from tendermint_tpu_torch.ops import bls_g1, bls_g2
    from tendermint_tpu_torch.ops import bls_pairing as bp
    from tendermint_tpu_torch.types import quorum_cert as qcm

    assert bls_native.native_lib() is not None, "native BLS library did not build"

    def scalar() -> int:
        return int.from_bytes(rng.bytes(32), "big") % (c.R - 1) + 1

    def g1(k):
        return bls._g1_mul_point(c.G1_GEN, k)

    def g2(k):
        return bls._g2_mul_point(c.G2_GEN, k)

    errs = {}

    # --- kernel vs plain: aggregates on 256 points with duplicates,
    # opposites and the identity among them (doubling and identity branches)
    g1s = [g1(scalar()) for _ in range(200)]
    g1s += g1s[:20] + [c.g1_neg(p) for p in g1s[20:40]] + [c.G1_INF] * 6 + [(0, 1, 0)] * 10
    g2s = [g2(scalar()) for _ in range(200)]
    g2s += g2s[:20] + [c.g2_neg(p) for p in g2s[20:40]] + [c.G2_INF] * 16
    p1 = torch.stack([bls_g1.g1_from_host(p) for p in g1s]).to(dev)
    p2 = torch.stack([bls_g2.g2_from_host(p) for p in g2s]).to(dev)
    for name, kern, plain, pts, add, inf, to_host, eq in (
        ("g1_aggregate", bls_g1.g1_aggregate, bls_g1.g1_aggregate_plain, p1,
         c.g1_add, c.G1_INF, bls_g1.g1_to_host, c.g1_eq),
        ("g2_aggregate", bls_g2.g2_aggregate, bls_g2.g2_aggregate_plain, p2,
         c.g2_add, c.G2_INF, bls_g2.g2_to_host, c.g2_eq),
    ):
        got, want = kern(pts), plain(pts)
        torch.cuda.synchronize()
        errs[name] = max_abs_err(got, want)
        assert errs[name] == 0, f"{name}: kernel != plain"
        acc = inf
        for p in (g1s if name == "g1_aggregate" else g2s):
            acc = add(acc, p)
        assert eq(to_host(got), acc), f"{name} != host oracle"

    # the pairing: the 2-pair verify shape and a 65-pair RLC shape whose
    # product is one (sum of a_i b_i cancelled by the last pair)
    a, b = [scalar() for _ in range(64)], [scalar() for _ in range(64)]
    rlc_pairs = [(g1(x), g2(y)) for x, y in zip(a, b)]
    rlc_pairs.append((g1(-sum(x * y for x, y in zip(a, b)) % c.R), c.G2_GEN))
    s = scalar()
    verify_pairs = [(g1(s), c.G2_GEN), (c.g1_neg(g1(1)), g2(s))]
    shapes = {"verify": verify_pairs, "rlc": rlc_pairs}
    chunks = {k: bp.prepare_pairs(v, dev) for k, v in shapes.items()}
    mill, plain_ms = {}, {}
    for k, ch in chunks.items():
        # the RLC shape is the timing shape: its one plain call is timed
        got = bp.miller(*ch)
        want, plain_ms["miller"] = time_once(torch, bp.miller_plain, *ch)
        fe_got = bp.final_exp(got.unsqueeze(0))
        fe_plain, plain_ms["final_exp"] = time_once(
            torch, bp.final_exp_plain, got.unsqueeze(0))
        torch.cuda.synchronize()
        errs["miller"] = max(errs.get("miller", 0), max_abs_err(got, want))
        errs["final_exp"] = max(errs.get("final_exp", 0), max_abs_err(fe_got, fe_plain))
        assert errs["miller"] == 0, f"tm_miller != plain ({k})"
        assert errs["final_exp"] == 0, f"tm_final_exp != plain ({k})"
        assert bp.f12_to_host(fe_got[0]) == c.F12_ONE, f"{k} product is not one"
        assert c.multi_pairing_is_one(shapes[k]), k
        mill[k] = got
    # adversarial operands: limbs 0, 1, p - 1 and >= p, off-curve points,
    # invalid and all-invalid chunks; kernel and plain version byte for byte
    adv_miller, adv_f12 = pairing_operands(torch, rng, dev)
    for ch in adv_miller:
        got, want = bp.miller(*ch), bp.miller_plain(*ch)
        torch.cuda.synchronize()
        errs["miller"] = max(errs["miller"], max_abs_err(got, want))
        assert errs["miller"] == 0, f"tm_miller != plain (adversarial, {ch[0].shape[0]} chunks)"
    got, want = bp.final_exp(adv_f12), bp.final_exp_plain(adv_f12)
    torch.cuda.synchronize()
    errs["final_exp"] = max(errs["final_exp"], max_abs_err(got, want))
    assert errs["final_exp"] == 0, "tm_final_exp != plain (adversarial)"
    # bilinearity: e(aP, bQ) == e(P, Q)^(ab)
    x, y = scalar(), scalar()
    P0, Q0 = g1(scalar()), g2(scalar())
    e_ab = bp.pairing_value([(bls._g1_mul_point(P0, x), bls._g2_mul_point(Q0, y))], dev)
    e_1 = bp.pairing_value([(P0, Q0)], dev)
    assert e_ab == f12_pow(c, e_1, x * y % c.R), "bilinearity"
    assert e_1 == c.pairing(P0, Q0), "pairing_value != host oracle"
    print("kernel-vs-plain: g1_aggregate, g2_aggregate (256 points with "
          "duplicates, opposites, identity), miller and final_exp (2-pair "
          "verify shape, 65-pair RLC shape; adversarial operands: limbs 0, 1, "
          "p - 1 and >= p, off-curve points, invalid and all-invalid chunks, "
          "the zero element) equal their plain versions (tolerance: exact) "
          "and the host oracle; e(aP, bQ) = e(P, Q)^(ab)")

    # --- the window: BLS keys for the 150 validators, QC shares on every
    # commit (set-up)
    t0 = time.perf_counter()
    qset, vals, privs, pubs = qc_keys(types, bls, qcm, vset, chain_id, entries, scalar, g2)
    keys_s = time.perf_counter() - t0
    n_win = len(entries)

    # the two routes of the JAX package's order: by default native pairing
    # and MSM on the host (no BLS kernel may launch); under
    # TM_TPU_BLS_PAIRING_DEVICE=1 every pairing check on the card, and the
    # named device sums (aggregate_signatures_device for each QC's shares,
    # aggregate_public_keys_device for its signer keys) beside assembly
    want = [h != QC_BAD for h in range(1, n_win + 1)]
    bls_kernels = ("g1_aggregate", "g2_aggregate", "miller", "final_exp")
    split_names = ("g1_from_bytes", "_qc_signer_key", "hash_to_g1", "_g1_mul_point",
                   "_pairing_is_one")
    routes = {}
    for route in ("native", "device"):
        if route == "device":
            os.environ[BLS_GATE] = "1"
        else:
            os.environ.pop(BLS_GATE, None)
        try:
            routes[route] = qc_route(
                torch, ops, bls, qcm, qset, vals, privs, chain_id, entries,
                split_names, route == "device")
        finally:
            os.environ.pop(BLS_GATE, None)
        r = routes[route]
        for v in r["verdicts"]:
            assert v == want, f"qc window verdicts ({route}) {v}"
        assert len(r["rounds"]) == 2 and all(
            e["rows"] == {"blocksync": n_win} for e in r["rounds"]), r["rounds"]
        if route == "native":
            for name in bls_kernels:
                assert r["asm_launches"][name] == r["win_launches"][name] == 0, \
                    f"{name} launched on the native route"
        else:
            for name in ("g1_aggregate", "g2_aggregate", "miller", "final_exp"):
                assert r["asm_launches"][name] > 0, f"{name} not launched assembling QCs"
            for name in ("miller", "final_exp"):
                assert r["win_launches"][name] > 0, f"{name} not launched on the QC window"
    assert [q.encode() for q in routes["native"]["qcs"]] == \
        [q.encode() for q in routes["device"]["qcs"]], "routes assembled other QCs"
    for route, r in routes.items():
        checks = r["win_launches"]["final_exp"] // 2
        print(f"main path: qc assembly ({route} route): {n_win} commits x {len(vals)} "
              f"validators through assemble_qc, every QC with all {len(vals)} signers"
              + (", each QC's signature sum and signer-key sum again through "
                 "aggregate_signatures_device / aggregate_public_keys_device, equal "
                 "to the native sums" if route == "device" else "")
              + f"; launches {json.dumps({k: v for k, v in r['asm_launches'].items() if v})}")
        print(f"main path: qc window ({route} route): verify_commits_qc over {n_win} QCs "
              f"(QC {QC_BAD} a sub-quorum aggregate under the full bitset) through a "
              f"started VerifyScheduler's qc_verify lane, x2; verdicts [True]*"
              f"{QC_BAD - 1} + [False] + [True]*{n_win - QC_BAD} each time; {checks} "
              f"card pairing checks per window; launches "
              f"{json.dumps({k: v for k, v in r['win_launches'].items() if v})}")
    dev_r = routes["device"]
    launches = {
        "g1_aggregate": dev_r["asm_launches"]["g1_aggregate"],
        "g2_aggregate": dev_r["asm_launches"]["g2_aggregate"],
        "miller": dev_r["asm_launches"]["miller"] + dev_r["win_launches"]["miller"],
        "final_exp": dev_r["asm_launches"]["final_exp"] + dev_r["win_launches"]["final_exp"],
    }

    # --- the aggregates at the device route's shapes, against their plain
    # versions (one timed call each) and the host oracle: each QC's 150
    # signatures (a tree padded to 256) and its 150 signer keys (one tree);
    # and the launch of the no-library QC engine (_g2_sums), 64 trees of
    # 150 keys in one grid (each tree padded, one block each), here each
    # tree the keys rotated by its index
    sigs = [bls.g1_from_bytes(cs.qc_signature) for cs in entries[0][2].signatures]
    sig_pts = torch.stack([bls_g1.g1_from_host(p) for p in sigs]).to(dev)
    key_pts = torch.stack([bls_g2.g2_from_host(pubs[v.address]) for v in vals])
    key_trees = key_pts.unsqueeze(0).to(dev)
    key_forest = torch.stack([key_pts.roll(t, 0) for t in range(n_win)]).to(dev)
    sig_forest = torch.stack([sig_pts.roll(t, 0) for t in range(n_win)])
    sig_sum, key_sum = c.G1_INF, c.G2_INF
    for p in sigs:
        sig_sum = c.g1_add(sig_sum, p)
    for v in vals:
        key_sum = c.g2_add(key_sum, pubs[v.address])
    sums = {}
    for name, kern, plain, pts in (
        ("g1_aggregate", bls_g1.g1_aggregate, bls_g1.g1_aggregate_plain, sig_pts),
        ("g2_aggregate", bls_g2.g2_aggregate, bls_g2.g2_aggregate_plain, key_trees),
        ("g2_forest", bls_g2.g2_aggregate, bls_g2.g2_aggregate_plain, key_forest),
        ("g1_forest", bls_g1.g1_aggregate, bls_g1.g1_aggregate_plain, sig_forest),
    ):
        got = kern(pts)
        want, t_ms = time_once(torch, plain, pts)
        err = max_abs_err(got, want)
        assert err == 0, f"{name}: kernel != plain at shape {tuple(pts.shape)}"
        kname = name.replace("forest", "aggregate")
        if kname == name:
            plain_ms[name] = t_ms
        errs[kname] = max(errs[kname], err)
        sums[name] = got.cpu()
    assert c.g1_eq(bls_g1.g1_to_host(sums["g1_aggregate"]), sig_sum), "g1 != host oracle"
    assert len(sums["g1_forest"]) == n_win and all(
        c.g1_eq(bls_g1.g1_to_host(t), sig_sum) for t in sums["g1_forest"]), \
        "g1_forest trees != host oracle"
    for name in ("g2_aggregate", "g2_forest"):
        assert len(sums[name]) == (n_win if name == "g2_forest" else 1)
        assert all(c.g2_eq(bls_g2.g2_to_host(t), key_sum) for t in sums[name]), \
            f"{name} trees != host oracle"
    print(f"kernel-vs-plain: g1_aggregate at {tuple(sig_pts.shape)}, "
          f"g2_aggregate at {tuple(key_trees.shape)} (the device route's shapes) "
          f"and at {tuple(key_forest.shape)} (the no-library QC engine's "
          f"{n_win}-tree launch), g1_aggregate also at {tuple(sig_forest.shape)}, "
          f"equal their plain versions (tolerance: exact) and the host oracle")

    # --- timings at the main path's shapes
    rlc = chunks["rlc"]
    f_one = mill["rlc"].unsqueeze(0).contiguous()
    n_rlc_chunks = rlc[0].shape[0]
    work = {
        "g1_aggregate": (
            lambda: bls_g1.g1_aggregate(sig_pts),
            sig_pts.numel() + 144,
            ((len(vals) - 1) * FP_G1_ADD + 3 * len(vals) + 3) * IMAD_PER_FP_MUL,
            "tendermint_tpu/ops/bls_g1.py:309",
        ),
        "g2_aggregate": (
            lambda: bls_g2.g2_aggregate(key_trees),
            key_trees.numel() + 288,
            ((len(vals) - 1) * FP_G2_ADD + 6 * len(vals) + 6) * IMAD_PER_FP_MUL,
            "tendermint_tpu/ops/bls_g2.py:214",
        ),
        "miller": (
            lambda: bp.miller(*rlc),
            sum(t.numel() for t in rlc) + 576,
            miller_fp_muls(len(rlc_pairs)) * IMAD_PER_FP_MUL,
            "tendermint_tpu/ops/bls_pairing.py:405",
        ),
        "final_exp": (
            lambda: bp.final_exp(f_one),
            2 * 576,
            FP_FINAL_EXP * IMAD_PER_FP_MUL,
            "tendermint_tpu/ops/bls_pairing.py:443",
        ),
    }
    rows = []
    for name, (kern, nbytes, n_ops, replaces) in work.items():
        ms = time_cuda(torch, kern, 20)
        b_ms, b_by = bound_ms(nbytes, n_ops)
        rows.append({
            "name": name, "route": "cuda", "source": BLS_SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms[name],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        print(f"time: {name} kernel {ms:.4f} ms plain {plain_ms[name]:.2f} ms "
              f"(one call) bound {b_ms:.5f} ms ({b_by}) | {smi}")
    vchunks = chunks["verify"]
    mv = time_cuda(torch, lambda: bp.miller(*vchunks), 20)
    print(f"time: miller at the 2-pair verify shape {mv:.4f} ms (1 chunk); "
          f"at the 65-pair RLC shape ({n_rlc_chunks} chunks) the miller row | {smi}")
    timings = {"miller_verify": mv,
               "g2_forest": time_cuda(torch, lambda: bls_g2.g2_aggregate(key_forest), 20),
               "g1_forest": time_cuda(torch, lambda: bls_g1.g1_aggregate(sig_forest), 20)}
    for name in ("miller", "final_exp", "g1_aggregate", "g2_aggregate"):
        timings[name.replace("miller", "miller_rlc")] = next(
            r["ms"] for r in rows if r["name"] == name)
    for k, pairs in shapes.items():
        g1b = b"".join(bls.g1_to_bytes(p) for p, _ in pairs)
        g2b = b"".join(bls.g2_to_bytes(q) for _, q in pairs)
        assert bls_native.pairing_check(g1b, g2b, len(pairs))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            bls_native.pairing_check(g1b, g2b, len(pairs))
            ts.append((time.perf_counter() - t0) * 1e3)
        card = []
        for _ in range(5):
            t0 = time.perf_counter()
            assert bp.check_pairs(pairs, dev)
            card.append((time.perf_counter() - t0) * 1e3)
        print(f"time: pairing check, {len(pairs)} pairs: native host library "
              f"(one CPU thread) median {statistics.median(ts):.3f} ms; "
              f"check_pairs on the card median {statistics.median(card):.3f} ms "
              f"(host prep, miller, final_exp, copies) | {smi}")
    print(f"time: qc set-up {keys_s:.1f} s ({len(vals)} BLS keys, 4 with a "
          f"proof-of-possession pairing; {n_win * len(vals)} signature shares, "
          f"host) | {smi}")
    labels = {"g1_from_bytes": "signature parse", "_qc_signer_key": "key parse",
              "hash_to_g1": "hash-to-G1", "_g1_mul_point": "scalar mults",
              "_pairing_is_one": "pairing checks"}
    for route, r in routes.items():
        print(f"time: qc assembly ({route} route) of {n_win} QCs "
              f"{r['assemble_s'] * 1e3:.1f} ms, {r['assemble_s'] * 1e3 / n_win:.2f} "
              f"ms per QC (assemble_qc alone)"
              + (f"; the device sums of the {n_win} QCs, host clock: signatures "
                 f"(aggregate_signatures_device) {r['sums_s']['g1'] * 1e3:.2f} ms, "
                 f"signer keys (aggregate_public_keys_device) "
                 f"{r['sums_s']['g2'] * 1e3:.2f} ms" if route == "device" else "")
              + f" | {smi}")
        for rep, (wall, acc) in enumerate(zip(r["walls"], r["splits"]), start=1):
            parts = ", ".join(f"{labels[k]} {acc.get(k, 0.0) * 1e3:.2f} ms"
                              for k in split_names)
            rest = wall - sum(acc.values())
            print(f"time: qc window {rep} ({route} route): wall {wall * 1e3:.2f} ms, "
                  f"{n_win / wall:.1f} QCs/s; {parts}; rest (tally, signer-key "
                  f"sums, RLC sums, scheduler) {rest * 1e3:.2f} ms | {smi}")
    point_sets = {
        "g1": [("the QC window's 150 signatures", sig_pts, sigs),
               ("256 adversarial points", p1, g1s)],
        "g2": [("the QC window's 150 keys", key_pts.to(dev),
                [pubs[v.address] for v in vals]),
               ("256 adversarial points", p2, g2s)],
    }
    return rows, point_sets, timings


# --- the mixed-key path (secp256k1) and the L2 block's merkle leaves --------

SECP_SOURCE = "tendermint_tpu_torch/ops/csrc/secp256k1_kernels.cu"
SHA256_SOURCE = "tendermint_tpu_torch/ops/csrc/sha256_kernels.cu"
# a field multiplication of secp256k1_device.cuh: 16 64x64->128-bit
# products and 5 in the fold, each four 32-bit multiply-adds
IMAD_PER_SECP_MUL = 21 * 4
# field multiplications of a doubling (2M + 5S) and an addition (12M + 4S)
FE_SECP_DBL, FE_SECP_ADD = 7, 16
# the four-lane kernel (a row on a group of SECP_ROW_LANES lanes): dependent
# product stages of a doubling (S_DBL) and an addition (S_HR, S_ADD_FIN) of
# its stage programs (ops/csrc/secp256k1_programs.cuh)
SECP_ROW_LANES = 4
SECP_DBL_PATH, SECP_ADD_PATH = 3, 5
SECP_SHARD_ROWS = 1024  # a shard of the mixed window's 8,192 rows over MESH_SHARDS
# SHA-256, per 64-byte block, in 32-bit instructions as nvcc compiles
# ops/csrc/sha256_device.cuh: 64 rounds of 21.75 with the schedule step
# (SASS of sha256_kernel, the full build less the rounds-emptied build,
# over 64: chip_kernels.py --kernel 9, "kernel9 sass:"), the 16 PRMT of
# the byte swaps and the 8 IADD3 of the feed-forward
SHA256_OPS_PER_BLOCK = 1392 + 16 + 8
# the dependent instructions of a SHA-256 round on one lane
# (sha256_device.cuh): e's rotations (SHF), their XOR (LOP3), then the adds
# into the next e and a (IADD3, once nvcc has reassociated them)
SHA256_ROUND_PATH = 3


def secp_crafted_rows(host, secp_native, rng):
    """64 rows of the secp256k1 kernel's operands as host integers,
    (Q affine, u1, u2, r, ok_in), and each row's verdict by the JAX
    package's rule: ok_in, R = u1 G + u2 Q not at infinity, and x(R) == r
    or (x(R) >= n and x(R) - n == r). Valid signatures; flipped s, wrong
    message, cross key; ok_in False; Q = G with u1 = u2 (the ladder meets
    P == Q); u2 = n - u1 with Q = G (R at infinity); a point T with
    x(T) >= n as Q with u1 = 0, u2 = 1 (r = x(T) - n takes the wrapped
    branch); the forged wrap r = x(R) - n + 2^256 for x(R) < n; u1 = u2 = 0;
    zero padding rows."""
    n_ord, g = host.N, (host.GX, host.GY)
    keys = [host.PrivKey.from_secret(b"smoke-secp-%d" % i) for i in range(4)]
    pubs = [k.public_key().data for k in keys]
    rows = []

    def signed(pub, msg, sig, ok=True):
        prep = secp_native.prep_digest_item(pub, hashlib.sha256(msg).digest(), sig)
        if prep is None:
            rows.append(((0, 0), 0, 0, 0, False))
        else:
            r, pt, u1, u2 = prep
            rows.append((pt, u1, u2, r, ok))

    for i in range(16):  # valid; for 8 of them flipped s, wrong message, cross key
        msg = b"crafted-%d" % i
        sig = keys[i % 4].sign(msg)
        signed(pubs[i % 4], msg, sig)
        if i < 8:
            signed(pubs[i % 4], msg, sig[:62] + bytes([sig[62] ^ 2]) + sig[63:])
            signed(pubs[i % 4], msg + b"!", sig)
            signed(pubs[(i + 1) % 4], msg, sig)
    for i in range(4):  # valid, but the host pre-checks said no
        msg = b"crafted-ok-%d" % i
        signed(pubs[i], msg, keys[i].sign(msg), ok=False)
    for i in range(4):  # Q = G, u1 = u2: the first add doubles
        u = int.from_bytes(rng.bytes(32), "big") % (n_ord - 1) + 1
        x = host._to_affine(host._jmul(2 * u, (*g, 1)))[0]
        rows.append((g, u, u, x % n_ord + (i % 2), True))
    for _ in range(2):  # u2 = n - u1, Q = G: R at infinity
        u = int.from_bytes(rng.bytes(32), "big") % (n_ord - 1) + 1
        rows.append((g, u, n_ord - u, 1, True))
    xt = n_ord
    while host._lift_x(xt, 0) is None:
        xt += 1
    t_pt = host._lift_x(xt, 0)
    for r in (xt - n_ord, xt, xt - n_ord + 1):
        rows.append((t_pt, 0, 1, r, True))
    q_pt = host.decompress_point(pubs[0])
    assert q_pt[0] < n_ord
    rows.append((q_pt, 0, 1, q_pt[0] - n_ord + (1 << 256), True))  # forged wrap
    rows.append((q_pt, 0, 1, q_pt[0], True))
    rows.append((q_pt, 0, 0, 1, True))  # u1 = u2 = 0
    while len(rows) < 64:
        rows.append(((0, 0), 0, 0, 0, False))
    want = []
    for (qx, qy), u1, u2, r, ok in rows:
        R = host._to_affine(host._jadd(host._jmul(u1, (*g, 1)), host._jmul(u2, (qx, qy, 1))))
        want.append(bool(ok) and R is not None
                    and (R[0] == r or (R[0] >= n_ord and R[0] - n_ord == r)))
    return rows, want


def secp_row_arrays(np, fe, rows):
    """The kernel's operands of host-integer rows: qx, qy [B, 32] int32
    limbs; u1, u2, r [B, 32] uint8 big-endian; ok_in [B] bool."""
    b = len(rows)
    qx = np.zeros((b, 32), np.int32)
    qy = np.zeros((b, 32), np.int32)
    u1 = np.zeros((b, 32), np.uint8)
    u2 = np.zeros((b, 32), np.uint8)
    rb = np.zeros((b, 32), np.uint8)
    ok = np.zeros(b, bool)
    for i, ((x, y), a, c, r, o) in enumerate(rows):
        qx[i], qy[i] = fe.from_int(x), fe.from_int(y)
        for arr, v in ((u1, a), (u2, c), (rb, r)):
            arr[i] = np.frombuffer(v.to_bytes(32, "big"), np.uint8)
        ok[i] = o
    return qx, qy, u1, u2, rb, ok


def _secp_row_count(u1: int, u2: int, dbl: int, add: int, check: int) -> int:
    """A count of one live row with these scalars, `dbl` a doubling and
    `add` an addition: the table of Q (7 doublings, 7 additions), then the
    ladder's doublings once the accumulator has left the identity and its
    additions of a nonzero digit onto a non-identity accumulator (the
    others return early), then `check` for the Z^2 check."""
    n, started = 7 * dbl + 7 * add, False
    for k in range(64):
        if started:
            n += 4 * dbl
        for s in (u2, u1):
            if (s >> (4 * (63 - k))) & 15:
                n += add if started else 0
                started = True
    return n + check


def secp_fe_muls(u1: int, u2: int) -> int:
    """Field multiplications of the one-thread row (the bound's count; on
    one thread they are also its critical path): Z^2 and the two
    compares."""
    return _secp_row_count(u1, u2, FE_SECP_DBL, FE_SECP_ADD, 3)


def secp_lane_path(u1: int, u2: int) -> int:
    """Dependent product stages of tm_secp_verify's four-lane row: Z^2,
    then r Z^2 and (r + n) Z^2 in one stage."""
    return _secp_row_count(u1, u2, SECP_DBL_PATH, SECP_ADD_PATH, 2)


def run_mixed_window(verifier, vset, chain_id, entries, reps, secp_native):
    """verify_commits_light over the mixed-key window `reps` times, from an
    executor thread through a started VerifyScheduler and
    default_dispatch("blocksync"), each rep's wall split by host timers
    (secp256k1 prep, the secp256k1 route, the ed25519 round, sign-bytes
    assembly); then the window's rows once more for the per-row bitmap.
    Returns (verdicts, walls, splits, bitmap, items, ledger entries)."""
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import (
        VerifyScheduler, default_dispatch, set_default_scheduler,
    )

    items = [it for _, _, c in entries for it in vset._gather_items(chain_id, c, True)[0]]
    ledger = DispatchLedger()
    sched = VerifyScheduler(verifier=verifier, ledger=ledger,
                            metrics=SchedulerMetrics(Registry("smoke_mixed")))
    verdicts, walls, splits = [], [], []

    async def go():
        await sched.start()
        loop = asyncio.get_running_loop()
        try:
            for _ in range(reps):
                acc = {}
                saved = [
                    (secp_native, timed(secp_native, ("prep_digest_item",), acc)),
                    (verifier, timed(verifier, ("verify", "_verify_secp_device"), acc)),
                    (vset, timed(vset, ("_gather_items",), acc)),
                ]
                try:
                    gc.collect()
                    t0 = time.perf_counter()
                    verdicts.append(await loop.run_in_executor(
                        None,
                        lambda: vset.verify_commits_light(
                            chain_id, entries, verifier=default_dispatch("blocksync")),
                    ))
                    walls.append(time.perf_counter() - t0)
                finally:
                    for obj, s in saved:
                        restore(obj, s)
                splits.append(acc)
            return await loop.run_in_executor(
                None, lambda: default_dispatch("blocksync").verify(items))
        finally:
            await sched.stop()

    set_default_scheduler(sched)
    try:
        bitmap = asyncio.run(go())
    finally:
        set_default_scheduler(None)
    return verdicts, walls, splits, [bool(v) for v in bitmap], items, ledger.entries()


def mixed_phase(torch, np, rng, dev, smi, ops, types, ed_keys, chain_id, heights):
    """Phase 6: the secp256k1 and SHA-256 kernels against their plain
    versions, then the mixed-key commit path (a 150-validator set, every
    third key secp256k1, equal power) per height and over a 64-commit
    blocksync window, the 4,002-leaf L2 block data hash and
    merkle_root_pow2 on the card. Returns the two kernels' rows, the
    secp256k1 kernel's operands at the window's shape (numpy) and its
    kernel10 figures (times at the window's and a shard's shape, paths)."""
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.crypto import ed25519 as ed_host
    from tendermint_tpu_torch.crypto import merkle
    from tendermint_tpu_torch.crypto import secp256k1 as host
    from tendermint_tpu_torch.crypto import secp_native
    from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry
    from tendermint_tpu_torch.ops import secp256k1_kernel as sk
    from tendermint_tpu_torch.ops import sha256 as s2
    from tendermint_tpu_torch.types.block import Data

    assert secp_native.native_lib() is not None, "native secp256k1 library did not build"
    D = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    errs, plain_ms = {}, {}

    # --- kernel vs plain: tm_secp_verify on the 64 crafted rows
    rows, want = secp_crafted_rows(host, secp_native, rng)
    crafted = tuple(D(a) for a in secp_row_arrays(np, sk.fe, rows))
    got = sk.verify_prehashed(*crafted)
    plain = sk.verify_prehashed_plain(*crafted)
    torch.cuda.synchronize()
    errs["secp"] = max_abs_err(got, plain)
    assert errs["secp"] == 0, "tm_secp_verify != plain (crafted rows)"
    assert got.cpu().tolist() == want, "tm_secp_verify != the JAX package's rule (crafted rows)"

    # --- tm_sha256: one-block leaves, the 2-block inner shape, ragged rows
    # (the device operands of each shape kept for the kernel9 line)
    sha_shapes = {}

    def sha_check(buf, cnt, msgs, label):
        sha_shapes[label] = (D(buf), D(cnt))
        got = s2.sha256_batch(*sha_shapes[label])
        plain, ms = time_once(torch, s2.sha256_batch_plain, *sha_shapes[label])
        err = max_abs_err(got, plain)
        assert err == 0, f"tm_sha256 != plain ({label})"
        assert [bytes(r) for r in got.cpu().numpy()[: len(msgs)]] == [
            hashlib.sha256(m).digest() for m in msgs], f"tm_sha256 != hashlib ({label})"
        errs["sha256"] = max(errs.get("sha256", 0), err)
        return ms

    leaves32 = [rng.bytes(32) for _ in range(4096)]
    buf, cnt = s2.pad_messages(leaves32, prefix=b"\x00")
    sha_check(buf, cnt, [b"\x00" + x for x in leaves32], "one-block leaves")
    pairs = [rng.bytes(64) for _ in range(2048)]
    buf, cnt = s2.pad_messages(pairs, prefix=b"\x01")
    sha_check(buf, cnt, [b"\x01" + x for x in pairs], "2-block inner rows")

    # the L2 block: 4000 transactions of 100-1024 bytes and its two payload
    # leaves, as Data.hash() gives them to the leaf batch: 4002 rows padded
    # to the 4096 bucket, the block axis (17 for the longest) to 32
    txs = [rng.bytes(int(k)) for k in rng.integers(100, 1025, 4000)]
    data = Data(txs=txs, l2_block_meta=rng.bytes(256), l2_batch_header=rng.bytes(128))
    leaves = [b"\x00" + tx for tx in txs] + [b"\x01" + data.l2_block_meta,
                                              b"\x02" + data.l2_batch_header]
    msgs = leaves + [b""] * (4096 - len(leaves))
    leaf_buf, leaf_cnt = s2.pad_messages(msgs, prefix=b"\x00")
    nblk = leaf_buf.shape[1] // 64
    leaf_buf = np.pad(leaf_buf, ((0, 0), (0, ((1 << (nblk - 1).bit_length()) - nblk) * 64)))
    plain_ms["sha256"] = sha_check(leaf_buf, leaf_cnt, [b"\x00" + x for x in msgs],
                                   "the leaf batch")
    sha_check(leaf_buf[:KERNEL9_PARTIAL], leaf_cnt[:KERNEL9_PARTIAL],
              [b"\x00" + x for x in msgs[:KERNEL9_PARTIAL]], "a partial last warp")
    print(f"kernel-vs-plain: secp_verify_prehashed on 64 crafted rows (valid, flipped "
          f"s, wrong message, cross key, ok_in False, Q = G with u1 = u2, R at "
          f"infinity, x(T) >= n direct and wrapped, the forged wrap, u1 = u2 = 0, "
          f"padding: {sum(want)} accepted) and sha256_batch on {len(leaves32)} "
          f"one-block rows, {len(pairs)} 2-block rows, the leaf batch "
          f"{tuple(leaf_buf.shape)} (ragged n_blocks) and its first {KERNEL9_PARTIAL} "
          f"rows (a partial last warp) equal their plain versions (tolerance: "
          f"exact), the JAX package's rule and hashlib")

    # --- the mixed-key set: every third validator holds a secp256k1 key
    t0 = time.perf_counter()
    signers = [host.PrivKey.from_secret(rng.bytes(32)) if i % 3 == 2 else k
               for i, k in enumerate(ed_keys)]
    vset = types.ValidatorSet([types.Validator(s.public_key(), 10) for s in signers])
    by_addr = {s.public_key().address(): s for s in signers}
    n_vals = len(vset.validators)
    is_secp = [v.pub_key.type_name == "secp256k1" for v in vset.validators]
    n_secp = sum(is_secp)

    def commit_at(height):
        bid = types.BlockID(hash=rng.bytes(32), part_set_header=types.PartSetHeader(
            total=1, hash=rng.bytes(32)))
        sigs = [types.CommitSig(types.BlockIDFlag.COMMIT, v.address,
                                1_700_000_000_000_000_000 + height * 10**9 + i)
                for i, v in enumerate(vset.validators)]
        commit = types.Commit(height, 0, bid, sigs)
        for i, v in enumerate(vset.validators):
            sigs[i].signature = by_addr[v.address].sign(commit.vote_sign_bytes(chain_id, i))
        return bid, commit

    commits = [commit_at(h) for h in range(1, heights + 2)]
    entries, tampered = signed_window(None, types, vset, by_addr, chain_id, WINDOW,
                                      QC_BAD, rng)
    setup_s = time.perf_counter() - t0
    assert {is_secp[i] for i in tampered} == {True, False}

    os.environ["TM_TPU_SECP_DEVICE"] = "1"  # the JAX package's gate, on
    try:
        # --- per height, through the process verifier on the card
        verifier = bv.default_verifier()
        ops.reset_launches()
        commit_ms = []
        for h, (bid, commit) in enumerate(commits[:heights], start=1):
            t0 = time.perf_counter()
            vset.verify_commit(chain_id, bid, h, commit)
            commit_ms.append((time.perf_counter() - t0) * 1e3)
        bid, commit = commits[-1]
        bad_i = max(i for i in range(n_vals) if is_secp[i])
        sig = commit.signatures[bad_i].signature
        commit.signatures[bad_i].signature = sig[:3] + bytes([sig[3] ^ 1]) + sig[4:]
        try:
            vset.verify_commit(chain_id, bid, heights + 1, commit)
        except ValueError as e:
            assert str(e) == f"wrong signature at index {bad_i}", e
        else:
            raise AssertionError("tampered mixed-key commit verified")
        torch.cuda.synchronize()
        height_launches = ops.kernel_launches()
        for name in ("verify_prehashed_table", "secp_verify_prehashed"):
            assert height_launches[name] > 0, f"{name} was not launched per height"
        print(f"main path: mixed verify_commit x{heights} at {n_vals} validators "
              f"({n_vals - n_secp} ed25519, {n_secp} secp256k1, TM_TPU_SECP_DEVICE=1) "
              f"ok; tampered secp256k1 index {bad_i} rejected; launches "
              f"{json.dumps({k: v for k, v in height_launches.items() if v})}")

        # --- the blocksync window, twice
        wverifier = bv.BatchVerifier(shape_registry=ShapeRegistry())
        ops.reset_launches()
        verdicts, walls, splits, bitmap, items, ledger = run_mixed_window(
            wverifier, vset, chain_id, entries, 2, secp_native)
        torch.cuda.synchronize()
        win_launches = ops.kernel_launches()
    finally:
        del os.environ["TM_TPU_SECP_DEVICE"]
    for name in ("neg_pubkey_bigtable", "verify_prehashed_bigcache", "secp_verify_prehashed"):
        assert win_launches[name] > 0, f"{name} was not launched on the mixed window"
    want_v = [h != QC_BAD for h in range(1, WINDOW + 1)]
    assert all(v == want_v for v in verdicts), verdicts
    bad_rows = {(QC_BAD - 1) * n_vals + i for i in tampered}
    assert [i for i, ok in enumerate(bitmap) if not ok] == sorted(bad_rows)
    secp_rows = [i for i, it in enumerate(items) if it.key_type == "secp256k1"]
    secp_items = [items[i] for i in secp_rows]
    assert len(secp_rows) == WINDOW * n_secp
    # the native host route over the same rows: the yardstick, and the
    # same verdicts
    t0 = time.perf_counter()
    native = secp_native.verify_msgs_batch(
        [it.pubkey for it in secp_items], [it.msg for it in secp_items],
        [it.sig for it in secp_items])
    native_s = time.perf_counter() - t0
    assert native == [bitmap[i] for i in secp_rows], "secp256k1 rows: kernel != native route"
    for i in rng.choice(len(items), size=256, replace=False):
        it = items[int(i)]
        key = host.PubKey(it.pubkey) if it.key_type == "secp256k1" else ed_host.PubKey(it.pubkey)
        assert bitmap[int(i)] == key.verify(it.msg, it.sig), i
    tiers = wverifier._registry.buckets_by_tier()
    rounds = [e for e in ledger if e["engine"] == "sig"]
    assert len(rounds) == 3 and all(e["rows"] == {"blocksync": len(items)} for e in rounds)
    b_secp = wverifier._registry.bucket_for(len(secp_rows))
    print(f"main path: mixed window: {WINDOW} commits x {n_vals} validators = "
          f"{len(items)} rows ({len(items) - len(secp_rows)} ed25519, "
          f"{len(secp_rows)} secp256k1 padded to {b_secp}), "
          f"tiers {json.dumps({k: list(v) for k, v in tiers.items()})}; verdicts "
          f"[True]*{QC_BAD - 1} + [False] + [True]*{WINDOW - QC_BAD} x2 (commit "
          f"{QC_BAD}: {len(tampered)} tampered signatures, ed25519 and "
          f"secp256k1); bitmap False on exactly those rows; secp256k1 rows = "
          f"the native host route; 256-row sample = host oracles; launches "
          f"{json.dumps({k: v for k, v in win_launches.items() if v})}")

    # --- the L2 block's data hash: the 4,002 leaves on the card (the
    # commit hash's 150 leaves stay under the gate, on the host)
    host_root = merkle.hash_from_byte_slices(leaves)
    merkle.DEVICE_LEAF_MIN = 1024
    ops.reset_launches()
    pad_acc = {}
    saved = timed(s2, ("pad_messages",), pad_acc)
    try:
        gc.collect()
        t0 = time.perf_counter()
        card_root = data.hash()
        card_s = time.perf_counter() - t0
        assert len(commits[0][1].hash()) == 32
    finally:
        restore(s2, saved)
        merkle.DEVICE_LEAF_MIN = 0
    torch.cuda.synchronize()
    data_launches = ops.kernel_launches()["sha256_batch"]
    assert data_launches == 1, data_launches
    assert card_root == host_root, "Data.hash() on the card != the host tree"
    t0 = time.perf_counter()
    assert merkle.hash_from_byte_slices(leaves) == host_root
    hashlib_s = time.perf_counter() - t0
    # merkle_root_pow2: 4096 leaves of 32 bytes, one leaf and 12 inner levels
    ops.reset_launches()
    root = s2.merkle_root_pow2(D(np.array(leaves32, dtype="S32").view(np.uint8).reshape(-1, 32)))
    torch.cuda.synchronize()
    root_launches = ops.kernel_launches()["sha256_batch"]
    assert root_launches == 13, root_launches
    assert bytes(root.cpu().numpy()) == merkle.hash_from_byte_slices(leaves32)
    print(f"main path: Data.hash() of {len(txs)} transactions + 2 L2 leaves "
          f"(TM_TPU_DEVICE_MERKLE_MIN=1024) on the card = the host tree, "
          f"{data_launches} launch; merkle_root_pow2 over {len(leaves32)} leaves "
          f"= the host tree, {root_launches} launches")

    # --- the secp256k1 kernel at the window's shape: its rows padded on the
    # ladder, prepared as _verify_secp_device prepares them
    w_rows = []
    for it in secp_items:
        r, pt, a, c = secp_native.prep_digest_item(
            it.pubkey, hashlib.sha256(it.msg).digest(), it.sig)
        w_rows.append((pt, a, c, r, True))
    live_muls = sum(secp_fe_muls(a, c) for _, a, c, _, _ in w_rows)
    lane_path = sum(secp_lane_path(a, c) for _, a, c, _, _ in w_rows) / len(w_rows)
    n_live = len(w_rows)
    w_rows += [((0, 0), 0, 0, 0, False)] * (b_secp - len(w_rows))
    w_arrays = secp_row_arrays(np, sk.fe, w_rows)
    w_args = tuple(D(a) for a in w_arrays)
    got = sk.verify_prehashed(*w_args)
    plain, plain_ms["secp"] = time_once(torch, sk.verify_prehashed_plain, *w_args)
    err = max_abs_err(got, plain)
    assert err == 0, f"tm_secp_verify != plain at ({b_secp},)"
    errs["secp"] = max(errs["secp"], err)
    assert got.cpu().tolist()[: len(secp_items)] == native
    # the same rows through the whole device route and the native route
    t0 = time.perf_counter()
    assert wverifier._verify_secp_device(secp_items).tolist() == native
    route_s = time.perf_counter() - t0
    print(f"kernel-vs-plain: secp_verify_prehashed at the window's shape ({b_secp} rows, "
          f"{len(secp_items)} live) equals its plain version (tolerance: exact)")
    # a mesh shard's shape: 1,024 rows, the window's share of them live
    shard_live = n_live * SECP_SHARD_ROWS // b_secp
    shard_idx = np.r_[0:shard_live, b_secp - (SECP_SHARD_ROWS - shard_live):b_secp]
    shard_args = tuple(D(a[shard_idx]) for a in w_arrays)
    assert sk.verify_prehashed(*shard_args).tolist() == got.cpu().numpy()[shard_idx].tolist()
    k10 = {"rows": b_secp, "live": n_live, "shard_live": shard_live,
           "shard_ms": time_cuda(torch, lambda: sk.verify_prehashed(*shard_args), 20),
           "lane_path": lane_path, "thread_path": live_muls / n_live}

    leaf_d, leaf_cnt_d = D(leaf_buf), D(leaf_cnt)
    work = {
        "secp_verify_prehashed": (
            lambda: sk.verify_prehashed(*w_args),
            len(secp_items) * (2 * 128 + 3 * 32 + 1) + b_secp + 16 * 3 * 32,
            live_muls * IMAD_PER_SECP_MUL,
            "tendermint_tpu/ops/secp256k1_kernel.py:161", SECP_SOURCE,
        ),
        "sha256_batch": (
            lambda: s2.sha256_batch(leaf_d, leaf_cnt_d),
            int(leaf_cnt.sum()) * 64 + 4 * len(leaf_cnt) + 32 * len(leaf_cnt),
            int(leaf_cnt.sum()) * SHA256_OPS_PER_BLOCK,
            "tendermint_tpu/ops/sha256.py:159", SHA256_SOURCE,
        ),
    }
    launches = {
        "secp_verify_prehashed": height_launches["secp_verify_prehashed"]
        + win_launches["secp_verify_prehashed"],
        "sha256_batch": data_launches + root_launches,
    }
    out_rows = []
    for name, (kern, nbytes, n_ops, replaces, source) in work.items():
        short = "secp" if name.startswith("secp") else "sha256"
        ms = time_cuda(torch, kern, 20)
        b_ms, b_by = bound_ms(nbytes, n_ops)
        out_rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[short], "ms": ms,
            "plain_ms": plain_ms[short], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        print(f"time: {name} kernel {ms:.4f} ms plain {plain_ms[short]:.2f} ms "
              f"(one call) bound {b_ms:.5f} ms ({b_by}); launches {launches[name]} | {smi}")
    print(f"time: mixed set-up {setup_s:.1f} s ({heights + 1} heights and the "
          f"{WINDOW}-commit window signed on the host, {n_secp} secp256k1 keys) | {smi}")
    print(f"time: mixed verify_commit ms per height "
          f"{[round(x, 3) for x in commit_ms]} | {smi}")
    print(f"time: secp256k1 rows of the window ({len(secp_items)}): native host route "
          f"{native_s * 1e3:.2f} ms (one CPU thread, prep included); device route "
          f"(_verify_secp_device: prep, copies, tm_secp_verify) {route_s * 1e3:.2f} ms | {smi}")
    labels = (("prep_digest_item", "secp256k1 host prep"), ("_verify_secp_device", None),
              ("verify", "ed25519 round"), ("_gather_items", "sign-bytes assembly"))
    for rep, (wall, acc) in enumerate(zip(walls, splits), start=1):
        prep = acc.get("prep_digest_item", 0.0)
        kern = acc.get("_verify_secp_device", 0.0) - prep
        rest = wall - acc.get("_verify_secp_device", 0.0) - acc.get("verify", 0.0) \
            - acc.get("_gather_items", 0.0)
        parts = ", ".join(f"{lab} {acc.get(k, 0.0) * 1e3:.2f} ms"
                          for k, lab in labels if lab)
        print(f"time: mixed window {rep}: wall {wall * 1e3:.2f} ms, "
              f"{WINDOW / wall:.1f} commits/s; {parts}; secp256k1 kernel with its "
              f"array fills and copies {kern * 1e3:.2f} ms; rest (tally, "
              f"scheduler) {rest * 1e3:.2f} ms | {smi}")
    pad_s = pad_acc.get("pad_messages", 0.0)
    print(f"time: L2 block data hash ({len(leaves)} leaves): card {card_s * 1e3:.2f} ms "
          f"(pad_messages {pad_s * 1e3:.2f} ms, the rest {(card_s - pad_s) * 1e3:.2f} ms: "
          f"copies, tm_sha256, the host fold); hashlib {hashlib_s * 1e3:.2f} ms | {smi}")
    k10["ms"] = next(r["ms"] for r in out_rows if r["name"] == "secp_verify_prehashed")
    k9 = {label: time_cuda(torch, lambda: s2.sha256_batch(*ops_d), 20)
          for label, ops_d in sha_shapes.items() if label != "the leaf batch"}
    k9["the leaf batch"] = next(r["ms"] for r in out_rows if r["name"] == "sha256_batch")
    k9 = {f"{label} {list(sha_shapes[label][0].shape)}": ms for label, ms in k9.items()}
    return out_rows, w_arrays, k10, k9


# --- the in-process consensus net --------------------------------------------


def committee_config(cls, n: int, **fields):
    """Static timeouts generous enough that a host-bound in-process
    committee never advances rounds on verify latency (the committee-scale
    configuration of the JAX package's benchmark); skip_timeout_commit."""
    scale = 1.0 + n / 25.0
    cfg = cls(timeout_propose=10.0 * scale, timeout_propose_delta=2.0,
              timeout_prevote=10.0 * scale, timeout_prevote_delta=2.0,
              timeout_precommit=10.0 * scale, timeout_precommit_delta=2.0,
              timeout_commit=0.05, skip_timeout_commit=True)
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def p2p_node(secret: bytes, network: str, name: str, reactor):
    """(node key, transport, switch) of one p2p node: a NodeKey from
    `secret`, a MultiplexTransport (listening on 127.0.0.1 once started)
    and a Switch carrying `reactor` under `name`."""
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.p2p.node_info import NodeInfo
    from tendermint_tpu_torch.p2p.switch import Switch
    from tendermint_tpu_torch.p2p.transport import MultiplexTransport

    nk = NodeKey(ed25519.PrivKey.from_secret(secret))
    box = {}

    def node_info():
        return NodeInfo(node_id=nk.id, listen_addr=f"127.0.0.1:{box['t'].listen_port}",
                        network=network,
                        channels=box["sw"].channels() if "sw" in box else b"")

    box["t"] = MultiplexTransport(nk, node_info)
    box["sw"] = Switch(box["t"])
    box["sw"].add_reactor(name, reactor)
    return nk, box["t"], box["sw"]


def wire_p2p(css, tag: bytes):
    """Mode (c)'s wiring: each node a NodeKey from the seed, a
    MultiplexTransport (listening on 127.0.0.1 once started), a Switch
    and a ConsensusReactor(vote_batch=True), which takes over the node's
    broadcast hook. Returns [(node key, transport, switch)]."""
    from tendermint_tpu_torch.consensus.reactor import ConsensusReactor

    return [p2p_node(tag + b"-node%d" % i, "smoke-net", "consensus",
                     ConsensusReactor(cs, vote_batch=True))
            for i, cs in enumerate(css)]


def run_net(torch, ops, seed: int, n_vals: int, heights: int, qc: bool,
            p2p: bool = False):
    """One n_vals-validator net in this process, every node
    KVStoreApplication through LocalClient, MemKV stores, MockL2Node and
    MockPV, all on the process verifier (the card) behind one started
    VerifyScheduler as the process default. Wired with the full-mesh
    broadcast hook, or with `p2p` over encrypted p2p through each node's
    ConsensusReactor (wire_p2p, ring plus chords of NET_PEER_DEGREE), whose
    VoteBatcher pre-verifies every gossiped vote through the scheduler. With
    `qc`: quorum certificates on, a BLS key per validator, batch points
    every 2 blocks with the L2 mock's registry verifier. Runs to
    heights + 1 and returns what the checks and the report need."""
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.consensus.state_machine import ConsensusConfig, ConsensusState
    from tendermint_tpu_torch.consensus.vote_batcher import VoteBatcher
    from tendermint_tpu_torch.crypto import bls_signatures as bls
    from tendermint_tpu_torch.crypto.bls12_381 import R
    from tendermint_tpu_torch.l2node.mock import MockL2Node
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.state import State
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.block_store import BlockStore
    from tendermint_tpu_torch.store.kv import MemKV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.p2p.transport import NetAddress
    from tendermint_tpu_torch.types.priv_validator import MockPV
    from tests.torch_chaos_harness import ring_peer_indices

    tag = b"%d-%s" % (seed, b"qc" if qc else b"p2p" if p2p else b"legacy")
    pvs = [MockPV.from_secret(tag + b"-%d" % i) for i in range(n_vals)]
    scalars = [int.from_bytes(hashlib.sha256(tag + b"-bls%d" % i).digest(), "big")
               % (R - 1) + 1 for i in range(n_vals)]
    registry = bls.BLSKeyRegistry()
    gvals = []
    for pv, k in zip(pvs, scalars):
        bls_key = b""
        if qc:
            pub = bls.pubkey_from_priv(k)  # a native proof-of-possession check
            registry.register(pv.get_pub_key().data, pub)
            bls_key = bls.g2_to_bytes(pub.key)
        gvals.append(GenesisValidator("ed25519", pv.get_pub_key().data, 10,
                                      bls_pub_key=bls_key))
    genesis = GenesisDoc(chain_id="smoke-net", genesis_time_ns=1_700_000_000 * 10**9,
                         validators=gvals)
    genesis.validate_and_complete()
    config = committee_config(ConsensusConfig, n_vals, quorum_certificates=qc)
    nodes = []
    for pv, k in zip(pvs, scalars):
        l2 = (MockL2Node(batch_blocks_interval=2, bls_verifier=registry.verifier())
              if qc else MockL2Node())
        state = State.from_genesis(genesis)
        state_store = StateStore(MemKV())
        state_store.bootstrap(state)
        block_store = BlockStore(MemKV())
        executor = BlockExecutor(state_store, block_store,
                                 LocalClient(KVStoreApplication()), l2)
        executor.qc_enabled = qc
        cs = ConsensusState(config, state, executor, block_store, l2, priv_validator=pv,
                            bls_signer=bls.signer_for(k) if qc else None)
        nodes.append((cs, l2, block_store))
    css = [n[0] for n in nodes]
    handles = wire_p2p(css, tag) if p2p else []
    if not p2p:
        for i, n in enumerate(css):
            def hook(msg, i=i):
                for j, other in enumerate(css):
                    if j != i:
                        other.peer_msg_queue.put_nowait((msg, f"node{i}"))

            n.broadcast_hook = hook
    ledger = DispatchLedger()
    sched = VerifyScheduler(ledger=ledger, metrics=SchedulerMetrics(
        Registry(f"smoke_net_{int(qc)}_{int(p2p)}")))
    marks = []
    # CUDA events around every kernel wrapper call of the net, recorded
    # just before the call and just after it returns, before the verdict
    # copy: the card's time for the wrapper's work, host launch gaps
    # between the events included (an upper bound on busy time). The
    # ledger's device_s is a host clock around the whole round, GIL waits
    # behind the nodes' event loop included. The verifier's _dispatch is
    # wrapped, not the kernel wrappers, whose launch counters are their
    # module globals. Every small-tier round's inputs and verdicts are
    # kept (cloned) for the check against the plain version.
    #
    # Which rounds carry VoteBatcher rows: every item a batcher submits is
    # live (its id in vote_ids) from its _verify_items call until the
    # verdicts return, which spans the scheduler round that holds it; the
    # verifier's prepare counts a round's live vote items on the prep
    # thread, and its run() carries that count to the dispatch thread.
    import threading

    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier

    verifier = default_verifier()
    events = []
    kept = {}
    dispatch = verifier._dispatch
    prepare = verifier.prepare
    vote_ids, vote_lock, tls = set(), threading.Lock(), threading.local()
    batcher_rounds, sched_rounds = [], []  # rows; (rows, vote rows)
    verify_items = VoteBatcher._verify_items

    def tracked_verify_items(self, items):
        with vote_lock:
            batcher_rounds.append(len(items))
            vote_ids.update(id(it) for it in items)
        try:
            return verify_items(self, items)
        finally:
            with vote_lock:
                vote_ids.difference_update(id(it) for it in items)

    def tagged_prepare(items):
        with vote_lock:
            n_vote = sum(id(it) in vote_ids for it in items)
        sched_rounds.append((len(items), n_vote))
        handle = prepare(items)
        run = handle.run

        def run_tagged():
            tls.vote_rows = n_vote
            try:
                return run()
            finally:
                tls.vote_rows = 0

        handle.run = run_tagged
        return handle

    def evented_dispatch(fn, tier, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        operands = []

        def evented(*a):
            start.record()
            got = fn(*a)
            end.record()
            operands.append(a)
            return got

        out = dispatch(evented, tier, *args, **kw)
        events.append((tier, start, end, getattr(tls, "vote_rows", 0)))
        if tier == "small":
            (a,) = operands  # one device: one launch
            kept.setdefault("small", []).append(([t.clone() for t in a], out.copy()))
        return out

    async def drive():
        await sched.start()
        for nk, t, sw in handles:
            await t.listen()
            await sw.start()
        for i, (nk, t, sw) in enumerate(handles):
            sw.dial_peers_async(
                [NetAddress(handles[j][0].id, "127.0.0.1", handles[j][1].listen_port)
                 for j in ring_peer_indices(i, n_vals, NET_PEER_DEGREE)],
                persistent=True)
        for cs in css:
            await cs.start()
        marks.append(time.perf_counter())
        try:
            for h in range(1, heights + 2):
                await asyncio.gather(*(cs.wait_for_height(h, timeout=180) for cs in css))
                marks.append(time.perf_counter())
        finally:
            for cs in css:
                await cs.stop()
            for nk, t, sw in handles:
                await sw.stop()
            await sched.stop()

    # where the host time goes: single-vote checks (on the event loop,
    # serial across nodes), LastCommit validation (executor threads,
    # scheduler waits included) and apply_block (awaits included)
    splits = {}
    saved_cs = timed(ConsensusState, ("_verify_vote",), splits)
    saved_ex = timed(BlockExecutor, ("validate_block",), splits)
    saved_ex.update(timed_async(BlockExecutor, "apply_block", splits))
    # single-vote checks split by whose vote: a node checks its own votes
    # (signed and queued to itself) and, without a reactor, every gossiped
    # one; with one, the gossiped votes its reactor delivered without a
    # verdict because no key resolved yet (pubkey_for_vote None: a vote of
    # a height the node has not reached). Each such vote object is held
    # (so no id is reused during the run); "rechecked" counts gossiped
    # checks of any other vote object, which the reactor passed or
    # dropped, and must stay 0. "copies" counts gossiped checks of a vote
    # whose signature the node's batcher passed in another copy (the same
    # vote from another peer, after its key resolved).
    vote_checks = {"own": 0, "gossiped": 0, "rechecked": 0, "copies": 0, "no_key": 0}
    passed = {}  # id(batcher) -> the signatures it pre-verified
    batcher_of = {id(sw.reactors["consensus"].cs): id(sw.reactors["consensus"].vote_batcher)
                  for nk, t, sw in handles}
    timed_vote = ConsensusState._verify_vote
    pubkey_for_vote = ConsensusState.pubkey_for_vote
    submit, submit_many = VoteBatcher.submit, VoteBatcher.submit_many
    no_key_votes = {}  # id -> vote: the votes delivered before their key resolved

    def counted_vote(self, vote, vals):
        own = (self._privval_pubkey is not None
               and vote.validator_address == self._privval_pubkey.address())
        vote_checks["own" if own else "gossiped"] += 1
        if own or id(self) not in batcher_of:
            pass  # without a reactor the node checks every gossiped vote
        elif no_key_votes.get(id(vote)) is not vote:
            vote_checks["rechecked"] += 1
        elif vote.signature in passed.get(batcher_of.get(id(self)), ()):
            vote_checks["copies"] += 1
        return timed_vote(self, vote, vals)

    def counted_pubkey(self, vote):
        pub = pubkey_for_vote(self, vote)
        if pub is None:
            vote_checks["no_key"] += 1
            no_key_votes[id(vote)] = vote
        return pub

    async def tracked_submit(self, pubkey, msg, sig, key_type="ed25519"):
        ok = await submit(self, pubkey, msg, sig, key_type=key_type)
        if ok:
            passed.setdefault(id(self), set()).add(sig)
        return ok

    async def tracked_submit_many(self, sigs):
        oks = await submit_many(self, sigs)
        passed.setdefault(id(self), set()).update(s[2] for s, ok in zip(sigs, oks) if ok)
        return oks

    ConsensusState._verify_vote = counted_vote
    ConsensusState.pubkey_for_vote = counted_pubkey
    VoteBatcher._verify_items = tracked_verify_items
    VoteBatcher.submit, VoteBatcher.submit_many = tracked_submit, tracked_submit_many
    gc.collect()
    ops.reset_launches()
    set_default_scheduler(sched)
    verifier._dispatch = evented_dispatch
    verifier.prepare = tagged_prepare
    try:
        asyncio.run(drive())
    finally:
        set_default_scheduler(None)
        del verifier._dispatch  # the instance attribute: the method shows again
        del verifier.prepare
        VoteBatcher._verify_items = verify_items
        VoteBatcher.submit, VoteBatcher.submit_many = submit, submit_many
        ConsensusState.pubkey_for_vote = pubkey_for_vote
        restore(ConsensusState, saved_cs)
        restore(BlockExecutor, saved_ex)
    torch.cuda.synchronize()
    kernel_ms = {}
    vote_launches = {}
    for name, start, end, n_vote in events:
        kernel_ms[name] = kernel_ms.get(name, 0.0) + start.elapsed_time(end)
        if n_vote:
            vote_launches[name] = vote_launches.get(name, 0) + 1
    return {"nodes": nodes, "pvs": pvs, "launches": ops.kernel_launches(),
            "ledger": ledger.entries(), "marks": marks, "kernel_ms": kernel_ms,
            "splits": splits, "kept": kept, "vote_checks": vote_checks,
            "batcher_rounds": batcher_rounds, "sched_rounds": sched_rounds,
            "vote_launches": vote_launches,
            "min_batch": css[0].verifier._min_device_batch}


def plain_over_rounds(torch, ed, kept, chunk_rows: int = 8192):
    """Kernel 3's plain version over the rows of many kept small-tier
    rounds at once: one concatenation of the rounds' distinct table stores
    (a round whose store equals the one before it shares it), each round's
    in-range table indices offset into it and its out-of-range ones set to
    -1 (both reject), the rows run in chunks. The plain version computes
    each row alone, so each row gets the verdict its round gives it.
    Returns the largest difference from the verdicts the net got, and the
    rows checked."""
    stores, valids, rows = [], [], []
    base = 0
    for (tables, tvalid, idx, r_b, s_b, k_b, s_ok), seen in kept:
        if not stores or not (torch.equal(tables, stores[-1])
                              and torch.equal(tvalid, valids[-1])):
            base += stores[-1].shape[0] if stores else 0
            stores.append(tables)
            valids.append(tvalid)
        idx = idx.to(torch.int64)
        in_range = (idx >= 0) & (idx < tables.shape[0])
        idx = torch.where(in_range, idx + base, torch.full_like(idx, -1)).to(torch.int32)
        rows.append((idx, r_b, s_b, k_b, s_ok, torch.from_numpy(seen)))
    tables, tvalid = torch.cat(stores), torch.cat(valids)
    cols = [torch.cat(c) for c in zip(*rows)]
    err = 0
    for lo in range(0, cols[0].shape[0], chunk_rows):
        idx, r_b, s_b, k_b, s_ok, seen = (c[lo:lo + chunk_rows] for c in cols)
        got = ed.verify_prehashed_table_plain(tables, tvalid, idx, r_b, s_b, k_b, s_ok)
        err = max(err, max_abs_err(seen, got))
    return err, int(cols[0].shape[0])


def consensus_phase(torch, ops, host, smi, seed: int, n_vals: int, heights: int):
    """Phase 7: the live net, legacy commits (mode a), QC heights with
    batch-point BLS dual-signing (mode b, the pairing gate unset) and
    legacy commits over encrypted p2p through each node's ConsensusReactor
    (mode c, its native AEAD loaded first). Checks agreement, the
    LastCommit signatures against the host oracle, the ledger's consensus
    rounds and the launch counts (mode c: kernel 3 launched on rounds that
    carry VoteBatcher rows), and holds every small-tier round against the
    plain version (modes a and b each at the shape it was dispatched, mode
    c its rounds' rows together; the first round also launched again with
    one row's challenge flipped); prints the walls. Returns the launches of
    the three modes, summed per kernel, and that check's max_abs_err per
    kernel."""
    from tendermint_tpu_torch.crypto import aead
    from tendermint_tpu_torch.ops import ed25519_batch as ed

    assert os.environ.get(BLS_GATE) is None
    # mode (c) seals every frame: the native library, or the net would
    # time pure-Python ChaCha20 and hide the card
    t0 = time.perf_counter()
    aead_lib = aead._native_lib()
    aead_s = time.perf_counter() - t0
    assert aead_lib is not None, "the native AEAD (_tmcrypto.so) did not load"
    print(f"main path: consensus net (p2p): AEAD route native, {aead_lib._name} "
          f"(built or loaded in {aead_s:.2f} s)")
    bls_kernels = ("g1_aggregate", "g2_aggregate", "miller", "final_exp")
    total, errs = {}, {}
    for mode, qc, p2p in NET_MODES:
        r = run_net(torch, ops, seed, n_vals, heights, qc, p2p=p2p)
        nodes, launches, ledger = r["nodes"], r["launches"], r["ledger"]
        bs0 = nodes[0][2]
        pubs = {pv.get_pub_key().address(): pv.get_pub_key().data for pv in r["pvs"]}
        for h in range(1, heights + 2):
            hashes = {n[2].load_block(h).hash() for n in nodes}
            assert len(hashes) == 1, f"{mode}: nodes disagree on block {h}"
        for h in range(2, heights + 2):  # each header carries the app hash of h - 1
            blk = bs0.load_block(h)
            assert len({n[2].load_block(h).header.app_hash for n in nodes}) == 1
            commit = blk.last_commit
            bitmap = [host.verify(pubs[cs.validator_address],
                                  commit.vote_sign_bytes(blk.header.chain_id, i),
                                  cs.signature)
                      for i, cs in enumerate(commit.signatures) if not cs.is_absent()]
            assert all(bitmap) and 3 * len(bitmap) > 2 * n_vals, (mode, h, bitmap)
        rounds = [e for e in ledger if "consensus" in e["rows"]]
        sig_rounds = [e for e in rounds if e["engine"] == "sig"
                      and e["requested"] >= r["min_batch"]]
        qc_rounds = [e for e in rounds if e["engine"] == "qc_verify"]
        for name in bls_kernels:
            assert launches[name] == 0, f"{mode}: {name} launched with the gate unset"
        if qc:
            l2 = nodes[0][1]
            points = [h for h in range(1, heights + 2) if bs0.load_block(h).header.batch_hash]
            assert points and l2.committed_batches, "qc: no batch point sealed"
            assert all(datas for _, datas in l2.committed_batches), "qc: batch without BLS data"
            carried = [h for h in range(2, heights + 2) if bs0.load_block(h).last_qc]
            assert carried, "qc: no block carried a QC"
            assert len(rounds) >= heights, (mode, rounds)
        else:
            assert len(sig_rounds) >= heights, (mode, ledger)
            for name in ("neg_pubkey_table", "verify_prehashed_table"):
                assert launches[name] > 0, f"{name} was not launched on the live net"
            if p2p:
                assert r["batcher_rounds"], "p2p: no VoteBatcher round"
                assert r["vote_launches"].get("small", 0) > 0, (
                    "p2p: verify_prehashed_table never ran a round with VoteBatcher rows")
                assert r["vote_checks"]["rechecked"] == 0, (
                    "p2p: the state machine checked a gossiped vote its reactor had a key "
                    "for (pre-verified, or dropped as invalid)",
                    r["vote_checks"])
                assert r["vote_checks"]["gossiped"] <= r["vote_checks"]["no_key"], (
                    "p2p: the state machine checked a gossiped vote its reactor could "
                    "have pre-verified", r["vote_checks"])
            if any(e["dispatched"] >= 512 for e in sig_rounds):
                for name in ("neg_pubkey_bigtable", "verify_prehashed_bigcache"):
                    assert launches[name] > 0, f"{name} was not launched on the live net"
            # every small-tier round, as the net dispatched it, against the
            # plain version: the verdicts the net got are the kernel's. Mode
            # (c)'s thousand-odd rounds at ~0.5 s a plain call would not fit
            # the smoke's limit: their rows run through the plain version
            # together (plain_over_rounds)
            rounds_err = 0
            t_check = time.perf_counter()
            n_kept = len(r["kept"]["small"])
            if p2p:
                rounds_err, n_checked = plain_over_rounds(torch, ed, r["kept"]["small"])
                how = (f"all {n_kept} of the {mode} net's small-tier rounds, their "
                       f"{n_checked} dispatched rows (padding included) through the "
                       f"plain version together over their table stores")
            else:
                for k_args, k_seen in r["kept"]["small"]:
                    k_plain = ed.verify_prehashed_table_plain(*k_args)
                    rounds_err = max(rounds_err,
                                     max_abs_err(torch.from_numpy(k_seen), k_plain))
                how = (f"all {n_kept} of the {mode} net's small-tier rounds as "
                       f"dispatched")
            assert rounds_err == 0, "a small-tier round of the net != plain"
            check_s = time.perf_counter() - t_check
            # the first again, launched here, and with row 0's challenge
            # flipped (every signature of the net is valid, so this is the
            # rejecting case)
            args, seen = r["kept"]["small"][0]
            n_rows = int(args[2].shape[0])
            assert seen[0], "first LastCommit round rejected its row 0"
            got = ed.verify_prehashed_table(*args)
            plain = ed.verify_prehashed_table_plain(*args)
            err = max(max_abs_err(got, plain),
                      max_abs_err(got, torch.from_numpy(seen)))
            bad_k = args[5].clone()
            bad_k[0, 0] ^= 1
            bad = args[:5] + [bad_k] + args[6:]
            got_bad = ed.verify_prehashed_table(*bad)
            plain_bad = ed.verify_prehashed_table_plain(*bad)
            err = max(err, max_abs_err(got_bad, plain_bad))
            assert err == 0, "verify_prehashed_table != plain on the net's round"
            assert not bool(got_bad[0]) and torch.equal(got_bad[1:].cpu(), got[1:].cpu()), \
                "the flipped challenge was not rejected alone"
            errs["verify_prehashed_table"] = max(errs.get("verify_prehashed_table", 0),
                                                 err, rounds_err)
            print(f"kernel-vs-plain: verify_prehashed_table on {how}: the "
                  f"verdicts the net got equal the plain version; the first "
                  f"({n_rows} rows over a store of {int(args[0].shape[0])} key "
                  f"tables; {int(seen.sum())} accepted) launched again, and with "
                  f"row 0's challenge flipped: equal to its plain version and to "
                  f"the verdicts the net got (tolerance: exact); the flipped row "
                  f"alone rejected; the plain versions of the rounds took "
                  f"{check_s:.1f} s")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        marks = r["marks"]
        walls = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        wall = marks[-1] - marks[0]
        sig_all = [e for e in rounds if e["engine"] == "sig"]
        device_s = sum(e["device_s"] for e in sig_rounds)
        prep_s = sum(e["host_prep_s"] for e in sig_rounds)
        oracle_s = sum(e["device_s"] for e in sig_all) - device_s
        qc_s = sum(e["device_s"] for e in qc_rounds)
        desc = ("quorum certificates, batch points every 2 blocks with BLS "
                "dual-signing through the registry verifier (pairing gate unset)"
                if qc else
                f"legacy commits over encrypted p2p (ChaCha20-Poly1305, native) "
                f"through ConsensusReactor(vote_batch=True), ring plus chords "
                f"of degree {NET_PEER_DEGREE}" if p2p else "legacy commits")
        extra = (f"; batch points at heights {points}, {len(l2.committed_batches)} "
                 f"batches committed to the L2 with {[len(d) for _, d in l2.committed_batches]} "
                 f"BLS datas; QCs carried by blocks {carried}" if qc else "")
        print(f"main path: consensus net ({mode}): {n_vals} validators in one "
              f"process, {desc}; {heights + 1} heights committed by every node, "
              f"same block (and app hash) on every node at every height; every "
              f"stored LastCommit signature true by the host oracle{extra}; "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
        print(f"main path: consensus net ({mode}): {len(sig_all)} consensus-class "
              f"signature rounds, {len(sig_rounds)} of them from min_device_batch "
              f"({r['min_batch']}) rows up; rows per round "
              f"{[e['requested'] for e in sig_all]}; buckets "
              f"{[e['dispatched'] for e in sig_all]}; {len(qc_rounds)} qc_verify "
              f"rounds ({sum(e['requested'] for e in qc_rounds)} certificates, "
              f"native host pairing) | {smi}")
        if p2p:
            mb = r["min_batch"]
            br = r["batcher_rounds"]
            vr = [(n, v) for n, v in r["sched_rounds"] if v]
            print(f"main path: consensus net ({mode}): {len(br)} VoteBatcher rounds "
                  f"({sum(br)} votes, rows per round mean {sum(br) / len(br):.2f}, "
                  f"max {max(br)}); {len(vr)} verifier rounds carried VoteBatcher "
                  f"rows (rows per round mean {sum(n for n, _ in vr) / max(1, len(vr)):.2f}"
                  f", max {max((n for n, _ in vr), default=0)}; vote rows per round "
                  f"mean {sum(v for _, v in vr) / max(1, len(vr)):.2f}), "
                  f"{sum(n < mb for n, _ in vr)} of them under min_device_batch "
                  f"({mb}) rows and so on the host oracle "
                  f"({sum(v for n, v in vr if n < mb)} votes), "
                  f"{sum(n >= mb for n, _ in vr)} on the card "
                  f"({sum(v for n, v in vr if n >= mb)} votes); kernel launches "
                  f"on rounds with VoteBatcher rows by tier "
                  f"{json.dumps(r['vote_launches'])}; single-vote checks by the "
                  f"state machine {json.dumps(r['vote_checks'])} | {smi}")
        busy = sum(r["kernel_ms"].values()) / 1e3
        print(f"time: consensus net ({mode}) ms per height {[round(w, 1) for w in walls]} "
              f"(first height, then steady); wall {wall * 1e3:.1f} ms; verify "
              f"kernel wrapper calls on the card by tier (CUDA events around "
              f"the call, before the verdict copy; launch gaps included) "
              f"{json.dumps({k: round(v, 3) for k, v in r['kernel_ms'].items()})} ms, "
              f"device busy share at most {busy / wall:.5f}, idle share at "
              f"least {1 - busy / wall:.5f}; ledger (host clocks, GIL waits included): "
              f"signature rounds from min_device_batch rows device_s "
              f"{device_s * 1e3:.2f} ms + host prepare {prep_s * 1e3:.2f} ms, "
              f"smaller signature rounds (host oracle) {oracle_s * 1e3:.2f} ms, "
              f"qc_verify rounds (host) {qc_s * 1e3:.2f} ms | {smi}")
        sp = r["splits"]
        per = n_vals * (heights + 1)  # node-heights
        print(f"time: consensus net ({mode}) host split: single-vote checks "
              f"(host oracle, on the event loop; {r['vote_checks']['own']} of the "
              f"node's own votes, {r['vote_checks']['gossiped']} gossiped, "
              f"{r['vote_checks']['rechecked']} of them delivered with a key, "
              f"{r['vote_checks']['copies']} copies of a vote the batcher passed "
              f"from another peer; {r['vote_checks']['no_key']} votes delivered "
              f"before their key resolved) "
              f"{sp.get('_verify_vote', 0.0) * 1e3:.1f} "
              f"ms = {sp.get('_verify_vote', 0.0) / wall:.3f} of the wall; "
              f"LastCommit validation (executor threads, scheduler waits "
              f"included) {sp.get('validate_block', 0.0) * 1e3:.1f} ms summed, "
              f"{sp.get('validate_block', 0.0) * 1e3 / per:.2f} ms per node-height; "
              f"apply_block (awaits included) {sp.get('apply_block', 0.0) * 1e3:.1f} "
              f"ms summed, {sp.get('apply_block', 0.0) * 1e3 / per:.2f} ms per "
              f"node-height | {smi}")
        del r, nodes
        gc.collect()
    return total, errs


# --- the catch-up path: blocksync over p2p, then the light client --------------

# the served chain: two windows of VERIFY_WINDOW (64) commits and the block
# whose LastCommit proves the last of them
CATCHUP_HEIGHTS = 2 * WINDOW + 1
# kvstore transactions per block, from the mock L2 node
CATCHUP_TXS = 3
# the lying peer's block whose LastCommit (the commit of the height before)
# carries tampered signatures of more than 1/3 of the power; within the 20
# heights the pool asks of a peer while it is the only one (a peer holds at
# most 20 pending requests, blocksync/pool.py _pick_peer)
CATCHUP_LIAR_BLOCK = 12
CATCHUP_TIMEOUT_S = 180
# rows of a mode's recorded rounds held against the host oracle
CATCHUP_SAMPLE_ROWS = 128
CATCHUP_T0 = 1_700_000_000 * 10**9
CATCHUP_PERIOD_NS = 3600 * 10**9  # the light client's trusting period


def catchup_chain(vkeys, powers, chain_id: str, n_heights: int):
    """The served chain: n_heights blocks of the seeded validator set (a
    MockPV over each key, its power), each a proposal block of the port's
    BlockExecutor with CATCHUP_TXS kvstore transactions of the mock L2 node
    (KVStoreApplication through LocalClient), every validator's precommit
    signed into a VoteSet and make_commit(), then apply_block (its
    LastCommit check on the process verifier) and BlockStore.save_block. A
    block's time is CATCHUP_T0 plus its height in seconds. The app starts
    with InitChain through the Handshaker, as a node's does (Node.on_start),
    so a node started by the CLI on the same genesis syncs the chain.
    Returns what the servers, the client and the light providers need."""
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.l2node.mock import MockL2Node
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.state import State
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.block_store import BlockStore
    from tendermint_tpu_torch.store.kv import MemKV
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.priv_validator import MockPV
    from tendermint_tpu_torch.types.vote import Vote, VoteType
    from tendermint_tpu_torch.types.vote_set import VoteSet

    pvs = {k.public_key().address(): MockPV(k) for k in vkeys}
    genesis = GenesisDoc(
        chain_id=chain_id, genesis_time_ns=CATCHUP_T0,
        validators=[GenesisValidator("ed25519", k.public_key().data, int(p))
                    for k, p in zip(vkeys, powers)])
    genesis.validate_and_complete()
    state = State.from_genesis(genesis)
    state_store = StateStore(MemKV())
    state_store.bootstrap(state)
    kv = MemKV()
    bs = BlockStore(kv)
    l2 = MockL2Node(txs_per_block=CATCHUP_TXS)
    executor = BlockExecutor(state_store, bs, LocalClient(KVStoreApplication()), l2)
    sign_s = [0.0]

    async def go(state):
        state = await Handshaker(state_store, bs, genesis, executor).handshake(state)
        last_commit = None
        for h in range(1, n_heights + 1):
            t = CATCHUP_T0 + h * 10**9
            block = executor.create_proposal_block(
                h, state, last_commit, state.validators.validators[0].address,
                l2.request_block_data(h), t)
            parts = block.make_part_set()
            bid = BlockID(block.hash(), parts.header)
            votes = VoteSet(chain_id, h, 0, VoteType.PRECOMMIT, state.validators)
            t0 = time.perf_counter()
            for i, v in enumerate(state.validators.validators):
                vote = Vote(type=VoteType.PRECOMMIT, height=h, round=0, block_id=bid,
                            timestamp_ns=t + 1 + i, validator_address=v.address,
                            validator_index=i)
                pvs[v.address].sign_vote(chain_id, vote)
                votes.add_vote(vote, verified=True)
            sign_s[0] += time.perf_counter() - t0
            commit = votes.make_commit()
            state = await executor.apply_block(state, bid, block)
            bs.save_block(block, parts, commit)
            last_commit = commit
        return state

    t0 = time.perf_counter()
    state = asyncio.run(go(state))
    return SimpleNamespace(genesis=genesis, kv=kv, bs=bs, state_store=state_store,
                           state=state, chain_id=chain_id, heights=n_heights,
                           build_s=time.perf_counter() - t0, sign_s=sign_s[0])


def tampered_commit(commit, indices):
    """A copy of commit with one bit of each signature at `indices` flipped."""
    import copy

    bad = copy.deepcopy(commit)
    for i in indices:
        sig = bad.signatures[i].signature
        bad.signatures[i].signature = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
    return bad


def catchup_store(src, liar_block: int | None = None):
    """A server's block store: a copy of the source's KV; for the lying
    peer the source's blocks saved anew, block liar_block's LastCommit
    tampered (heaviest_third)."""
    import copy

    from tendermint_tpu_torch.store.block_store import BlockStore
    from tendermint_tpu_torch.store.kv import MemKV

    kv = MemKV()
    if liar_block is None:
        kv._d = dict(src.kv._d)
        return BlockStore(kv)
    bs = BlockStore(kv)
    for h in range(1, src.heights + 1):
        block = src.bs.load_block(h)
        if h == liar_block:
            block = copy.deepcopy(block)
            block.last_commit = tampered_commit(
                block.last_commit, heaviest_third(src.state_store.load_validators(h - 1)))
        bs.save_block(block, block.make_part_set(), src.bs.load_seen_commit(h))
    return bs


def catchup_node(src, store=None, app=None, event_bus=None):
    """(state, executor, block store, l2) of a node of src's chain from
    genesis: `app` (an ABCI client) or its own KVStoreApplication through
    LocalClient, MemKV state store, MockL2Node; `store` (a server's) or a
    fresh block store; the executor publishes to `event_bus` if given."""
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.l2node.mock import MockL2Node
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.state import State
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.block_store import BlockStore
    from tendermint_tpu_torch.store.kv import MemKV

    state = State.from_genesis(src.genesis)
    state_store = StateStore(MemKV())
    state_store.bootstrap(state)
    bs = store if store is not None else BlockStore(MemKV())
    l2 = MockL2Node(txs_per_block=CATCHUP_TXS)
    app = app if app is not None else LocalClient(KVStoreApplication())
    return state, BlockExecutor(state_store, bs, app, l2, event_bus=event_bus), bs, l2


class RoundRecorder:
    """The rounds of the process verifier while installed: each round's
    items and verdicts (prepare, then its run on the scheduler's dispatch
    thread), and each kernel wrapper call's tier, bucket, rows, CUDA events
    recorded just before and after it (before the verdict copy; an upper
    bound on the card's busy time) and its operands and verdicts (cloned;
    a table store equal to the last kept one is shared). With `tag`, each
    round's tag(items), taken when it is prepared, rides along to its
    dispatches (`round_tags`, a dispatch's "tag")."""

    def __init__(self, torch, verifier, tag=None):
        self.torch, self.verifier, self.tag = torch, verifier, tag
        self.rounds, self.dispatches, self.round_tags = [], [], []
        self._tls = threading.local()

    def install(self):
        torch, verifier = self.torch, self.verifier
        prepare, dispatch = verifier.prepare, verifier._dispatch

        def recorded_prepare(items):
            tag = self.tag(items) if self.tag is not None else None
            handle = prepare(items)
            run = handle.run

            def recorded_run():
                self._tls.tag = tag
                try:
                    out = run()
                finally:
                    self._tls.tag = None
                self.rounds.append((list(items), [bool(v) for v in out]))
                self.round_tags.append(tag)
                return out

            handle.run = recorded_run
            return handle

        def recorded_dispatch(fn, tier, b, n, *args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            operands = []

            def evented(*a):
                start.record()
                got = fn(*a)
                end.record()
                operands.append(a)
                return got

            out = dispatch(evented, tier, b, n, *args, **kw)
            (a,) = operands  # one device: one launch
            kept = [t.clone() for t in a]
            last = next((d["operands"] for d in reversed(self.dispatches)
                         if d["tier"] == tier), None)
            if last is not None and torch.equal(last[0], a[0]) and torch.equal(last[1], a[1]):
                kept[0], kept[1] = last[0], last[1]
            self.dispatches.append({"tier": tier, "bucket": b, "rows": n, "start": start,
                                    "end": end, "operands": kept, "seen": out.copy(),
                                    "tag": getattr(self._tls, "tag", None)})
            return out

        verifier.prepare, verifier._dispatch = recorded_prepare, recorded_dispatch

    def remove(self):
        del self.verifier.prepare  # the instance attributes: the methods show again
        del self.verifier._dispatch

    def busy_ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(d["start"].elapsed_time(d["end"]) for d in self.dispatches)


def check_recorded(torch, ed, host, rec, rng, window_min_rows: int, label: str) -> dict:
    """Holds a mode's recorded rounds: each round of more than
    window_min_rows rows or off the small tier (a window) against its
    tier's plain version at the shape it was dispatched; the other
    small-tier rounds together
    (plain_over_rounds); CATCHUP_SAMPLE_ROWS seeded rows of the rounds
    against the host oracle. Returns the check's figures."""
    plain_of = {"big": ed.verify_prehashed_bigcache_plain,
                "small": ed.verify_prehashed_table_plain}
    err = {}
    windows = [d for d in rec.dispatches if d["rows"] > window_min_rows or d["tier"] != "small"]
    t0 = time.perf_counter()
    for d in windows:
        assert d["tier"] in plain_of, (label, d["tier"])
        got = plain_of[d["tier"]](*d["operands"])
        e = max_abs_err(torch.from_numpy(d["seen"]), got)
        name = "verify_prehashed_bigcache" if d["tier"] == "big" else "verify_prehashed_table"
        err[name] = max(err.get(name, 0), e)
        assert e == 0, f"{label}: a window round ({d['rows']} rows) != plain"
    window_s = time.perf_counter() - t0
    small = [(d["operands"], d["seen"]) for d in rec.dispatches
             if d["tier"] == "small" and d["rows"] <= window_min_rows]
    t0 = time.perf_counter()
    n_small_rows = 0
    if small:
        e, n_small_rows = plain_over_rounds(torch, ed, small)
        err["verify_prehashed_table"] = max(err.get("verify_prehashed_table", 0), e)
        assert e == 0, f"{label}: a small-tier round != plain"
    small_s = time.perf_counter() - t0
    rows = [(r, i) for r, (items, _) in enumerate(rec.rounds) for i in range(len(items))]
    t0 = time.perf_counter()
    for j in rng.choice(len(rows), size=min(CATCHUP_SAMPLE_ROWS, len(rows)), replace=False):
        r, i = rows[int(j)]
        it, seen = rec.rounds[r][0][i], rec.rounds[r][1][i]
        assert bool(seen) == host.verify(it.pubkey, it.msg, it.sig), (label, r, i)
    oracle_s = time.perf_counter() - t0
    return {"err": err, "windows": len(windows), "window_s": window_s,
            "small_rounds": len(small), "small_rows": n_small_rows, "small_s": small_s,
            "sampled": min(CATCHUP_SAMPLE_ROWS, len(rows)), "oracle_s": oracle_s}


def catchup_sync(torch, ops, src, liar: bool, timeout: float = CATCHUP_TIMEOUT_S,
                 n_honest: int = 2, plane=None):
    """One fresh node blocksyncs src's chain from genesis over encrypted p2p
    (modes a and b of the catch-up phase, and phase 12). `n_honest` honest
    servers, each a BlocksyncReactor(active=False) over a copy of the
    source's block store with its own NodeKey, MultiplexTransport on
    127.0.0.1 and Switch; with `liar` one more whose block
    CATCHUP_LIAR_BLOCK carries a LastCommit with tampered signatures of
    more than 1/3 of the power, dialed first and alone until the client's
    pool has asked it for its first heights. The client's BlocksyncReactor
    syncs with start_sync() through one started VerifyScheduler as the
    process default (its windows through default_dispatch("blocksync")).
    With `plane` (an EventPlane) the client's app is the plane's ABCI
    client and its executor publishes to the plane; the plane starts on
    the sync's event loop before the servers are dialed and settles once
    the client caught up. The launch counts are set to 0 just before the
    sync and read when it caught up. Returns what the checks and the
    report need."""
    from tendermint_tpu_torch.blocksync.reactor import BlocksyncReactor
    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.p2p.transport import NetAddress
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    label = "b" if liar else "e" if plane is not None else "a"
    servers = []
    for i, store in enumerate([catchup_store(src) for _ in range(n_honest)]
                              + ([catchup_store(src, CATCHUP_LIAR_BLOCK)] if liar else [])):
        state, executor, bs, l2 = catchup_node(src, store)
        r = BlocksyncReactor(state, executor, bs, l2, active=False)
        servers.append(p2p_node(b"catchup-%s-server%d" % (label.encode(), i),
                                "smoke-catchup", "blocksync", r))
    honest, liars = servers[:n_honest], servers[n_honest:]
    state, executor, cli_bs, cli_l2 = catchup_node(
        src, app=plane.app if plane is not None else None, event_bus=plane)
    caught = asyncio.Event()
    caught_at = []

    async def on_caught_up(st):
        caught_at.append((time.perf_counter(), st.last_block_height))
        caught.set()

    client = BlocksyncReactor(state, executor, cli_bs, cli_l2, on_caught_up=on_caught_up,
                              active=False)
    cnk, ct, csw = p2p_node(b"catchup-%s-client" % label.encode(), "smoke-catchup",
                            "blocksync", client)
    errors = []
    report = client.pool._on_peer_error

    def on_peer_error(pid, reason):
        errors.append((pid, reason))
        report(pid, reason)

    client.pool._on_peer_error = on_peer_error

    # where the time goes: window rounds (verify_commits_light, executor
    # threads), per-block verifies outside apply_block (the reactor's
    # fallback), apply_block (awaits included) and its LastCommit check
    # (validate_block, executor threads)
    windows, fallback, applied = [], [], []
    split = {"window": 0.0, "fallback": 0.0, "apply": 0.0, "validate": 0.0,
             "process": 0.0, "receive": 0.0}
    tls = threading.local()
    v_light, v_one = ValidatorSet.verify_commits_light, ValidatorSet.verify_commit_light
    validate, apply = BlockExecutor.validate_block, BlockExecutor.apply_block

    def timed_window(self, chain_id, entries, verifier=None):
        t0 = time.perf_counter()
        out = v_light(self, chain_id, entries, verifier=verifier)
        split["window"] += time.perf_counter() - t0
        windows.append(([h for _, h, _ in entries], list(out)))
        return out

    def timed_one(self, *a, **k):
        if getattr(tls, "validating", False):
            return v_one(self, *a, **k)
        t0 = time.perf_counter()
        try:
            return v_one(self, *a, **k)
        finally:
            split["fallback"] += time.perf_counter() - t0
            fallback.append(a[2])

    def timed_validate(self, *a, **k):
        tls.validating = True
        t0 = time.perf_counter()
        try:
            return validate(self, *a, **k)
        finally:
            tls.validating = False
            split["validate"] += time.perf_counter() - t0

    async def timed_apply(self, st, block_id, block, *a, **k):
        t0 = time.perf_counter()
        new = await apply(self, st, block_id, block, *a, **k)
        split["apply"] += time.perf_counter() - t0
        if self is executor:
            applied.append((block.header.height, new.app_hash))
        return new

    # the reactor's passes over ready blocks (windows and applies inside,
    # awaits included) and its message handler (block decoding, on the
    # event loop, interleaved with the passes' awaits)
    process, receive = client._process_ready_blocks, client.receive

    async def timed_process():
        t0 = time.perf_counter()
        try:
            return await process()
        finally:
            split["process"] += time.perf_counter() - t0

    async def timed_receive(channel_id, peer, msg):
        t0 = time.perf_counter()
        try:
            return await receive(channel_id, peer, msg)
        finally:
            split["receive"] += time.perf_counter() - t0

    client._process_ready_blocks, client.receive = timed_process, timed_receive
    verifier = default_verifier()
    rec = RoundRecorder(torch, verifier)
    ledger = DispatchLedger()
    sched = VerifyScheduler(ledger=ledger, metrics=SchedulerMetrics(
        Registry(f"smoke_catchup_{label}")))
    marks = {}

    async def wait_for(cond, what, limit=30.0):
        deadline = time.perf_counter() + limit
        while not cond():
            assert time.perf_counter() < deadline, f"catch-up ({label}): no {what}"
            await asyncio.sleep(0.01)

    async def drive():
        from tendermint_tpu_torch.consensus.replay import Handshaker

        await sched.start()
        if plane is not None:
            await plane.start()
        # a node's start: its app's InitChain through the Handshaker, as
        # the source chain's was (Node.on_start)
        client.state = await Handshaker(
            executor._state_store, cli_bs, src.genesis, executor).handshake(client.state)
        for _, t, sw in servers + [(cnk, ct, csw)]:
            await t.listen()
            await sw.start()
        try:
            def addr(h):
                return NetAddress(h[0].id, "127.0.0.1", h[1].listen_port)

            for nk, t, sw in liars:
                await csw.dial_peer(addr((nk, t)))
                await wait_for(lambda: nk.id in client.pool._peers, "status from the liar")
            if liars:
                # alone, the lying peer is asked for the first 20 heights
                marks["start"] = time.perf_counter()
                client.start_sync()
                liar_id = liars[0][0].id
                await wait_for(lambda: errors or getattr(client.pool._requesters.get(
                    CATCHUP_LIAR_BLOCK), "peer_id", "") == liar_id, "request to the liar")
            for nk, t, sw in honest:
                await csw.dial_peer(addr((nk, t)))
            await wait_for(lambda: all(h[0].id in client.pool._peers for h in honest),
                           "status from the honest servers")
            if not liars:
                marks["start"] = time.perf_counter()
                client.start_sync()
            await asyncio.wait_for(caught.wait(), timeout)
            marks["end"] = time.perf_counter()
            marks["peers_left"] = set(csw.peers)
            if plane is not None:
                await plane.settle()
        finally:
            for _, t, sw in [(cnk, ct, csw)] + servers:
                await sw.stop()
            await sched.stop()
            if plane is not None:
                await plane.close()

    gc.collect()
    ValidatorSet.verify_commits_light, ValidatorSet.verify_commit_light = timed_window, timed_one
    BlockExecutor.validate_block, BlockExecutor.apply_block = timed_validate, timed_apply
    set_default_scheduler(sched)
    rec.install()
    ops.reset_launches()
    try:
        asyncio.run(drive())
        torch.cuda.synchronize()
        launches = ops.kernel_launches()
    finally:
        rec.remove()
        set_default_scheduler(None)
        ValidatorSet.verify_commits_light, ValidatorSet.verify_commit_light = v_light, v_one
        BlockExecutor.validate_block, BlockExecutor.apply_block = validate, apply
    return {"label": label, "client": client, "bs": cli_bs, "caught_at": caught_at,
            "marks": marks, "errors": errors, "windows": windows, "fallback": fallback,
            "applied": applied, "split": split, "rec": rec, "ledger": ledger.entries(),
            "launches": launches, "liar_id": liars[0][0].id if liars else None,
            "state_store": executor._state_store,
            "honest_ids": [h[0].id for h in honest]}


class StoreProvider:
    """A light-client provider over a node's block and state stores: the
    header of block h, the commit that proves it (block h + 1's LastCommit,
    or the seen commit at the tip) and the validator set at h. `commits`
    overrides the commit at some heights."""

    def __init__(self, name: str, src, commits=None):
        self.name, self.src, self.commits = name, src, commits or {}

    async def light_block(self, height: int):
        from tendermint_tpu_torch.light.types import LightBlock

        if height == 0:
            height = self.src.bs.height
        block = self.src.bs.load_block(height)
        if block is None:
            return None
        commit = (self.commits.get(height) or self.src.bs.load_block_commit(height)
                  or self.src.bs.load_seen_commit(height))
        return LightBlock(block.header, commit, self.src.state_store.load_validators(height))

    def id(self) -> str:
        return self.name


def catchup_light(torch, ops, src, tip: int):
    """Mode (c) of the catch-up phase: a LightClient trusted at height 1,
    its primary and one witness StoreProviders over the source, verifies
    to `tip` sequentially and then (a new client) by skipping, each round
    through default_dispatch("light") and one started VerifyScheduler; then
    a client trusted at CATCHUP_LIAR_BLOCK - 2 is served height
    CATCHUP_LIAR_BLOCK - 1 with the lying peer's tampered commit, and must
    reject it. Launch counts set to 0 before, read after."""
    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.light.client import LightClient, LightClientError, TrustOptions
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.light.verifier import VerificationError
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler
    from tendermint_tpu_torch.store.kv import MemKV

    now = CATCHUP_T0 + (src.heights + 60) * 10**9
    bad_h = CATCHUP_LIAR_BLOCK - 1
    bad_vals = src.state_store.load_validators(bad_h)
    tampered = heaviest_third(bad_vals)
    bad_commit = tampered_commit(src.bs.load_block_commit(bad_h), tampered)

    def client(trust_h, primary, sequential):
        return LightClient(
            src.chain_id,
            TrustOptions(CATCHUP_PERIOD_NS, trust_h, src.bs.load_block(trust_h).hash()),
            primary, [StoreProvider("witness", src)], LightStore(MemKV()),
            sequential=sequential, now_ns=lambda: now)

    verifier = default_verifier()
    rec = RoundRecorder(torch, verifier)
    ledger = DispatchLedger()
    sched = VerifyScheduler(ledger=ledger, metrics=SchedulerMetrics(
        Registry("smoke_catchup_light")))
    out = {}

    async def drive():
        await sched.start()
        try:
            for name, sequential in (("sequential", True), ("skipping", False)):
                c = client(1, StoreProvider("primary", src), sequential)
                n0 = len(rec.rounds)
                t0 = time.perf_counter()
                lb = await c.verify_light_block_at_height(tip)
                out[name] = {"s": time.perf_counter() - t0, "rounds": len(rec.rounds) - n0,
                             "trusted": c.store.heights(), "hash": lb.header.hash()}
            c = client(bad_h - 1, StoreProvider("lying-primary", src, {bad_h: bad_commit}), True)
            n0 = len(rec.rounds)
            try:
                await c.verify_light_block_at_height(bad_h)
            except (LightClientError, VerificationError) as e:
                out["rejected"] = repr(e)
            out["reject_rounds"] = rec.rounds[n0:]
            out["reject_trusted"] = c.store.heights()
        finally:
            await sched.stop()

    gc.collect()
    set_default_scheduler(sched)
    rec.install()
    ops.reset_launches()
    try:
        asyncio.run(drive())
        torch.cuda.synchronize()
        out["launches"] = ops.kernel_launches()
    finally:
        rec.remove()
        set_default_scheduler(None)
    out.update(rec=rec, ledger=ledger.entries(), tampered=tampered, bad_h=bad_h,
               bad_vals=bad_vals, bad_commit=bad_commit)
    return out


def catchup_phase(torch, ops, host, smi, rng, vkeys, powers, chain_id: str,
                  bare_walls: list):
    """Phase 9: a node that joins or restarts catches up. Builds the served
    chain (catchup_chain, CATCHUP_HEIGHTS blocks of the seeded validator
    set), then mode (a): a fresh node blocksyncs it from two honest peers
    over encrypted p2p (catchup_sync); mode (b): the same with a lying third
    peer; mode (c): the light client over the same chain (catchup_light).
    Checks each mode's result, the launches and every recorded round
    (check_recorded), and prints the walls and splits beside phase 3's bare
    window (`bare_walls`, seconds). Returns the launches of the three modes,
    summed per kernel, the checks' max_abs_err per kernel, the served chain
    (phases 10-12 serve it again) and modes (a) and (b)'s walls and mode
    (c)'s sequential step ("c_step"), seconds."""
    from tendermint_tpu_torch.crypto import aead
    from tendermint_tpu_torch.ops import ed25519_batch as ed

    t0 = time.perf_counter()
    aead_lib = aead._native_lib()
    aead_s = time.perf_counter() - t0
    assert aead_lib is not None, "the native AEAD (_tmcrypto.so) did not load"
    print(f"main path: catch-up: AEAD route native, {aead_lib._name} (built or "
          f"loaded in {aead_s:.2f} s)")
    n_vals = len(vkeys)
    src = catchup_chain(vkeys, powers, chain_id + "-catchup", CATCHUP_HEIGHTS)
    tip = src.heights - 1  # the last height a commit proves
    print(f"main path: catch-up: served chain of {src.heights} heights, "
          f"{n_vals} validators, {CATCHUP_TXS} kvstore txs a block, built through "
          f"the BlockExecutor in {src.build_s:.1f} s ({src.sign_s:.1f} s of it "
          f"signing {src.heights * n_vals} precommits on the host)")
    want_hash = {h: src.bs.load_block(h).hash() for h in range(1, src.heights + 1)}
    want_app = {h: src.bs.load_block(h + 1).header.app_hash for h in range(1, tip + 1)}
    total, errs, walls = {}, {}, {}
    bare = ", ".join(f"{w * 1e3:.2f}" for w in bare_walls)
    for liar in (False, True):
        r = catchup_sync(torch, ops, src, liar)
        label, launches, marks = r["label"], r["launches"], r["marks"]
        assert r["caught_at"], f"catch-up ({label}): on_caught_up never fired"
        assert r["bs"].height == tip, (label, r["bs"].height)
        assert r["client"].state.last_block_height == tip
        for h in range(1, tip + 1):
            assert r["bs"].load_block(h).hash() == want_hash[h], (label, h)
        got_app = dict(r["applied"])
        assert sorted(got_app) == list(range(1, tip + 1)), (label, sorted(got_app)[:5])
        for h in range(1, tip + 1):
            assert got_app[h] == want_app[h], (label, "app hash", h)
        assert launches["verify_prehashed_bigcache"] > 0, f"catch-up ({label}): kernel 6 not launched"
        if not liar:
            assert launches["neg_pubkey_bigtable"] >= 1, "catch-up (a): kernel 5 not launched"
        assert launches["verify_prehashed_table"] > 0, f"catch-up ({label}): kernel 3 not launched"
        flagged = [(hs, v) for hs, v in r["windows"] if not all(v)]
        if liar:
            bad = CATCHUP_LIAR_BLOCK - 1
            assert any(hs[v.index(False)] == bad for hs, v in flagged), (
                "catch-up (b): no window verdict flagged the lying peer's height", flagged)
            punished = {pid for pid, _ in r["errors"]}
            assert punished == {r["liar_id"]}, ("catch-up (b): punished", punished)
            assert r["liar_id"] not in marks["peers_left"], "catch-up (b): the liar is still a peer"
        else:
            assert not flagged and not r["errors"], (flagged, r["errors"])
        chk = check_recorded(torch, ed, host, r["rec"], rng, n_vals, f"catch-up ({label})")
        for k, v in chk["err"].items():
            errs[k] = max(errs.get(k, 0), v)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        wall = walls[label] = marks["end"] - marks["start"]
        sp = r["split"]
        busy = r["rec"].busy_ms() / 1e3
        rounds = [d for d in r["rec"].dispatches if d["rows"] > n_vals]
        other = wall - sp["window"] - sp["fallback"] - sp["apply"]
        desc = ("two honest peers" if not liar else
                f"two honest peers and a lying one (block {CATCHUP_LIAR_BLOCK}'s LastCommit "
                f"tampered, {len(heaviest_third(src.state_store.load_validators(CATCHUP_LIAR_BLOCK - 1)))} "
                f"signatures of more than 1/3 of the power)")
        extra = ""
        if liar:
            hs, v = next((hs, v) for hs, v in flagged)
            extra = (f"; the window over heights {hs[0]}-{hs[-1]} flagged height "
                     f"{hs[v.index(False)]}; the pool punished the lying peer alone "
                     f"({r['errors'][0][1]!r}) and it left the client's switch; the "
                     f"reactor's per-block check re-judged heights {r['fallback'][:4]}")
        print(f"main path: catch-up ({label}): a fresh node blocksynced {tip} heights "
              f"from {desc} over encrypted p2p (ChaCha20-Poly1305, native) through "
              f"BlocksyncReactor.start_sync(); on_caught_up at height "
              f"{r['caught_at'][0][1]}; every block hash and the app hash after "
              f"every height equal the source's{extra}; launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})} | {smi}")
        print(f"main path: catch-up ({label}): {len(r['windows'])} window rounds, "
              f"(commits, rows, bucket, tier) "
              f"{[(d['rows'] // n_vals, d['rows'], d['bucket'], d['tier']) for d in rounds]}; "
              f"{len(r['fallback'])} per-block verifies outside apply_block; "
              f"{len(r['applied'])} applied blocks, each one LastCommit round of "
              f"{n_vals} rows on the small tier; every window round equal to its "
              f"plain version at its shape ({chk['windows']} rounds, {chk['window_s']:.1f} s), "
              f"the {chk['small_rounds']} small-tier rounds' {chk['small_rows']} rows "
              f"through the plain version together ({chk['small_s']:.1f} s), "
              f"{chk['sampled']} seeded rows equal to the host oracle (tolerance: exact)")
        print(f"time: catch-up ({label}): {wall * 1e3:.2f} ms to catch up {tip} heights, "
              f"{tip / wall:.1f} commits/s; split: window verify rounds "
              f"{sp['window'] * 1e3:.2f} ms, per-block verifies outside apply "
              f"{sp['fallback'] * 1e3:.2f} ms, apply_block {sp['apply'] * 1e3:.2f} ms "
              f"(its LastCommit check {sp['validate'] * 1e3:.2f} ms), waiting on the "
              f"pool or p2p and the reactor's own work {other * 1e3:.2f} ms (of the "
              f"wall: the reactor's passes over ready blocks {sp['process'] * 1e3:.2f} "
              f"ms, windows and applies inside, so outside them, pool ticks and "
              f"requests, {(wall - sp['process']) * 1e3:.2f} ms; its message handler, "
              f"block decoding on the event loop, {sp['receive'] * 1e3:.2f} ms); kernel "
              f"wrapper calls on the card (CUDA events, launch gaps included) "
              f"{busy * 1e3:.2f} ms, device busy share at most {busy / wall:.5f}; "
              f"phase 3's bare window of {WINDOW} commits in this run {bare} ms | {smi}")
        del r
        gc.collect()
    c = catchup_light(torch, ops, src, tip)
    launches = c["launches"]
    for name in ("sequential", "skipping"):
        assert c[name]["hash"] == want_hash[tip], name
    assert c["sequential"]["trusted"] == list(range(1, tip + 1)), c["sequential"]["trusted"][:5]
    assert c["skipping"]["trusted"][-1] == tip
    assert "rejected" in c, "catch-up (c): the tampered commit was accepted"
    assert "invalid commit" in c["rejected"], c["rejected"]
    assert c["bad_h"] not in c["reject_trusted"]
    bad_rounds = [(items, seen) for items, seen in c["reject_rounds"] if not all(seen)]
    assert bad_rounds, "catch-up (c): no round rejected a tampered row"
    items, seen = bad_rounds[0]
    want = [host.verify(it.pubkey, it.msg, it.sig) for it in items]
    assert list(seen) == want and want.count(False) == len(c["tampered"]), "catch-up (c)"
    assert launches["verify_prehashed_table"] > 0, "catch-up (c): kernel 3 not launched"
    light_rounds = [e for e in c["ledger"] if "light" in e["rows"]]
    assert len(light_rounds) >= tip, (len(light_rounds), tip)
    assert all(d["tier"] == "small" for d in c["rec"].dispatches), "catch-up (c): not kernel 3"
    chk = check_recorded(torch, ed, host, c["rec"], rng, n_vals, "catch-up (c)")
    for k, v in chk["err"].items():
        errs[k] = max(errs.get(k, 0), v)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    seq, skip = c["sequential"], c["skipping"]
    print(f"main path: catch-up (c): LightClient trusted at height 1, a primary and a "
          f"witness over the source's stores: sequential to {tip} in {seq['rounds']} "
          f"rounds of {n_vals} rows, skipping in {skip['rounds']} rounds (trusted "
          f"heights {skip['trusted']}), both to the source's header; height "
          f"{c['bad_h']} with {len(c['tampered'])} tampered signatures rejected "
          f"({c['rejected'][:80]}), its tampered rows alone false, as the host "
          f"oracle; {len(light_rounds)} light-class ledger rounds, all on the small "
          f"tier; the {chk['small_rounds']} rounds' {chk['small_rows']} rows equal to "
          f"the plain version together, {chk['sampled']} seeded rows to the host "
          f"oracle (tolerance: exact); launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} | {smi}")
    print(f"time: catch-up (c): light client sequential {seq['s'] * 1e3 / (tip - 1):.2f} ms "
          f"a step ({tip - 1} steps, {seq['s'] * 1e3:.2f} ms), skipping "
          f"{skip['s'] * 1e3 / max(1, len(skip['trusted']) - 1):.2f} ms a step "
          f"({len(skip['trusted']) - 1} steps, {skip['s'] * 1e3:.2f} ms, the witness "
          f"cross-check included); kernel wrapper calls on the card "
          f"{c['rec'].busy_ms():.2f} ms | {smi}")
    walls["c_step"] = seq["s"] / (tip - 1)
    return total, errs, src, walls


# --- the bulk rest and the chaos mesh ------------------------------------------

# light clients of the serving plane's swarm (tools/lightserve_bench.py's count)
SWARM_CLIENTS = 1000
# validators of the chaos mesh: at 4 most vote rounds fall under
# min_device_batch (8) and never reach the card; phase 7's mode (c) showed
# 32 cost 6-16 s a height
CHAOS_VALIDATORS = 16
# the seeded storm of tests/test_chaos.py: latency, jitter, drop, duplicate
CHAOS_SEED = 7
CHAOS_STORM = {"latency_s": 0.005, "jitter_s": 0.01, "drop": 0.02, "duplicate": 0.02}
CHAOS_STORM_HEIGHT = 4
CHAOS_SKEW = 1.2  # n3's clock under the storm
CHAOS_STALL_S = 2.0  # the 8|8 partition must commit nothing for this long
# ... once nothing a late vote would move (each node's height, round and
# step, the votes it holds for its round, the votes queued toward its state
# machine) has changed over CHAOS_SETTLE_S of polls, each one a turn of the
# mesh's loop: longer than the reactor's slowest periodic gossip (the 2 s
# maj23 query), and a loop that stalls cannot count as quiet
CHAOS_SETTLE_S = 2.5
CHAOS_SETTLE_POLL_S = 0.1
CHAOS_TIMEOUT_S = 150  # a bound on each wait of the mesh
# the mesh's whole wall: past it a wait fails at once, so a slow host fails
# the smoke here, with the nodes' states, well before the chip tool's limit
CHAOS_WALL_S = 240
# heights the mesh commits after the heal, and after the kill and the restart
CHAOS_HEAL_HEIGHTS = 2
CHAOS_KILL_HEIGHTS = 1
# the chip tool's limit on the whole smoke, which prints its walls beside it
SMOKE_LIMIT_S = 1200
# round timeouts of the chaos mesh (seconds, and their growth a round): a
# proposer killed, or restarted and still catching up, costs one propose
# timeout, not committee_config's 16 s
CHAOS_TIMEOUTS = {"timeout_propose": 5.0, "timeout_propose_delta": 1.0,
                  "timeout_prevote": 2.0, "timeout_prevote_delta": 0.5,
                  "timeout_precommit": 2.0, "timeout_precommit_delta": 0.5}
GUARD_HANG_S = 2.0  # the bound of the guard's probe of a hanging child


def run_bounded(coro, teardown_s: float = 30.0):
    """asyncio.run(coro) with a bounded teardown: leftover tasks are
    cancelled and waited for at most teardown_s, and the default executor
    is not joined (a thread still blocked on a round of the stopped loop
    must not hold a failing run; main exits without joining it)."""
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    try:
        return loop.run_until_complete(coro)
    finally:
        tasks = [t for t in asyncio.all_tasks(loop) if not t.done()]
        for t in tasks:
            t.cancel()
        if tasks:
            loop.run_until_complete(asyncio.wait(tasks, timeout=teardown_s))
        loop.run_until_complete(loop.shutdown_asyncgens())
        asyncio.set_event_loop(None)
        loop.close()


def ledger_rounds(ledger) -> list:
    """(classes, rows, bucket, merged submissions) of each ledger round."""
    return [("+".join(e["classes"]), e["requested"], e["dispatched"], e["submissions"])
            for e in ledger]


def serve_swarm(torch, ops, src, vkeys, n_clients: int, now_ns: int):
    """Part (a) of phase 10: n_clients LightClients sync src's chain from
    the trust root at height 1 to its last proven height through one
    LightServePlane over the source node's stores (the port's
    tools/lightserve_bench.py's client loop and scenarios, through tests/
    torch_lightserve_swarm.py's run_swarm), its ServeVerifier on a started
    VerifyScheduler's lightserve lane, that scheduler the process default;
    then the swarm's divergent-witness and forged-header scenarios. Launch
    counts set to 0 before, read after; every round recorded."""
    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler
    from tendermint_tpu_torch.types.priv_validator import MockPV
    from tests.torch_lightserve_swarm import run_swarm, served_chain

    chain = served_chain(src.bs, src.state_store, src.state_store.load_validators(1),
                         [MockPV(k) for k in vkeys], src.chain_id, now_ns=lambda: now_ns)
    rec = RoundRecorder(torch, default_verifier())
    ledger = DispatchLedger()
    sched = VerifyScheduler(ledger=ledger, metrics=SchedulerMetrics(Registry("smoke_lightserve")))
    gc.collect()
    set_default_scheduler(sched)
    rec.install()
    ops.reset_launches()
    try:
        stats = run_swarm(n_clients=n_clients, chain=chain, scheduler=sched)
        torch.cuda.synchronize()
        launches = ops.kernel_launches()
    finally:
        rec.remove()
        set_default_scheduler(None)
    return {"stats": stats, "rec": rec, "ledger": ledger.entries(), "launches": launches}


def gossip_evidence(torch, ops, src, vkeys, ev, timeout: float = 30.0):
    """Part (b) of phase 10: the honest node's EvidencePool (over the
    source's stores) verifies and accepts `ev` from an executor thread
    (default_dispatch("evidence") through a started VerifyScheduler); its
    EvidenceReactor gossips it over encrypted p2p to a second node's pool
    (over a copy of the block store), which verifies and accepts it on
    receipt. Then copies with one signature and with the heaviest third of
    the power's signatures flipped, and a DuplicateVoteEvidence of one
    validator (and a copy with a flipped signature), each through the
    honest pool. Launch counts set to 0 before, read after."""
    import copy

    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier
    from tendermint_tpu_torch.evidence import EvidencePool, EvidenceReactor
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.p2p.transport import NetAddress
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler
    from tendermint_tpu_torch.store.kv import MemKV
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
    from tendermint_tpu_torch.types.part_set import PartSetHeader
    from tendermint_tpu_torch.types.priv_validator import MockPV
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    pool_a = EvidencePool(MemKV(), src.state_store, src.bs)
    pool_b = EvidencePool(MemKV(), src.state_store, catchup_store(src))
    node_a = p2p_node(b"evidence-a", "smoke-evidence", "evidence", EvidenceReactor(pool_a))
    node_b = p2p_node(b"evidence-b", "smoke-evidence", "evidence", EvidenceReactor(pool_b))
    vals = src.state_store.load_validators(ev.height())
    tampered = heaviest_third(vals)

    def flipped(indices):
        commit = Commit.decode(ev.conflicting_commit)
        for i in indices:
            sig = commit.signatures[i].signature
            commit.signatures[i].signature = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
        bad = copy.copy(ev)
        bad.conflicting_commit = commit.encode()
        return bad

    # an equivocation of the first validator at the height before the fork
    dup_h = ev.height()
    meta = src.bs.load_block_meta(dup_h)
    val = vals.validators[0]
    pv = next(MockPV(k) for k in vkeys if k.public_key().address() == val.address)

    def vote(block_hash):
        v = Vote(type=VoteType.PRECOMMIT, height=dup_h, round=0,
                 block_id=BlockID(block_hash, PartSetHeader(1, block_hash)),
                 timestamp_ns=meta.header.time_ns, validator_address=val.address,
                 validator_index=0)
        pv.sign_vote(src.chain_id, v)
        return v

    va, vb = vote(b"\x01" * 32), vote(b"\x02" * 32)
    dup = DuplicateVoteEvidence.from_votes(va, vb, vals.total_voting_power(),
                                           val.voting_power, meta.header.time_ns)
    vb_bad = copy.deepcopy(vb)
    vb_bad.signature = bytes([vb_bad.signature[0] ^ 1]) + vb_bad.signature[1:]
    dup_bad = DuplicateVoteEvidence.from_votes(va, vb_bad, vals.total_voting_power(),
                                               val.voting_power, meta.header.time_ns)
    rec = RoundRecorder(torch, default_verifier())
    ledger = DispatchLedger()
    sched = VerifyScheduler(ledger=ledger, metrics=SchedulerMetrics(Registry("smoke_evidence")))
    out = {"verdicts": {}}

    async def judge(name, evidence):
        loop = asyncio.get_running_loop()
        n0 = len(rec.rounds)
        t0 = time.perf_counter()
        try:
            await loop.run_in_executor(None, pool_a.add_evidence, evidence)
            verdict = "accepted"
        except ValueError as e:
            verdict = f"rejected ({e})"
        out["verdicts"][name] = (verdict, time.perf_counter() - t0,
                                 [len(items) for items, _ in rec.rounds[n0:]])

    async def drive():
        await sched.start()
        for _, t, sw in (node_a, node_b):
            await t.listen()
            await sw.start()
        try:
            await node_a[2].dial_peer(NetAddress(node_b[0].id, "127.0.0.1",
                                                 node_b[1].listen_port))
            t0 = time.perf_counter()
            await judge("light-client attack", ev)
            deadline = time.perf_counter() + timeout
            while pool_b.size() < 1:
                assert time.perf_counter() < deadline, "evidence: no gossip to the second pool"
                await asyncio.sleep(0.02)
            out["gossip_s"] = time.perf_counter() - t0
            out["b_pending"] = [e.encode() for e in pool_b.pending_evidence()]
            await judge("attack, one signature flipped", flipped([0]))
            await judge("attack, the heaviest third flipped", flipped(tampered))
            await judge("duplicate vote", dup)
            await judge("duplicate vote, a signature flipped", dup_bad)
        finally:
            for _, t, sw in (node_a, node_b):
                await sw.stop()
            await sched.stop()

    gc.collect()
    set_default_scheduler(sched)
    rec.install()
    ops.reset_launches()
    try:
        asyncio.run(drive())
        torch.cuda.synchronize()
        out["launches"] = ops.kernel_launches()
    finally:
        rec.remove()
        set_default_scheduler(None)
    out.update(rec=rec, ledger=ledger.entries(), a_pending=pool_a.pending_evidence(),
               tampered=tampered, dup=dup)
    return out


def chaos_mesh(torch, ops, n_vals: int, device: str = "cuda"):
    """Part (c) of phase 10: n_vals validators over encrypted p2p built by
    tests/torch_chaos_harness.py on `device`, the process verifier behind
    one started VerifyScheduler as the process default (every gossiped vote
    through its node's VoteBatcher), with ChaosNetwork installed by a
    ScenarioRunner: the seeded storm (CHAOS_STORM, n3's clock at
    CHAOS_SKEW from height 2) to CHAOS_STORM_HEIGHT; an even partition that
    must commit nothing for CHAOS_STALL_S, healed, CHAOS_HEAL_HEIGHTS more
    heights; n3 killed, CHAOS_KILL_HEIGHTS without it, restarted with fresh
    p2p around its state, CHAOS_KILL_HEIGHTS more on every node; every wait
    inside CHAOS_WALL_S. Launch counts set to 0 before,
    read after; every round recorded, tagged with its VoteBatcher rows; the
    storm under a ProfileCapture's loop profile (device=False) armed on the
    mesh's event-loop thread, its samples' shares by port directory
    (loop_shares)."""
    import shutil
    import tempfile

    from tendermint_tpu_torch.chaos import LinkPolicy, Scenario, ScenarioRunner, Step
    from tendermint_tpu_torch.consensus.state_machine import ConsensusConfig
    from tendermint_tpu_torch.consensus.vote_batcher import VoteBatcher
    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.obs.profiler import ProfileCapture
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler
    from tests.torch_chaos_harness import build_chaos_handles, chain_hashes, start_mesh, stop_mesh

    config = committee_config(ConsensusConfig, n_vals, **CHAOS_TIMEOUTS)
    handles = build_chaos_handles(n_vals, config=config, device=device)
    names = [h.name for h in handles]
    scenario = Scenario(
        seed=CHAOS_SEED,
        steps=[Step(at_height=2, action="clock_skew", params={"node": "n3", "scale": CHAOS_SKEW})],
        default_policy=LinkPolicy(**CHAOS_STORM),
    )
    runner = ScenarioRunner(handles, scenario)
    vote_ids, vote_lock = set(), threading.Lock()
    batcher_rounds = []
    verify_items = VoteBatcher._verify_items

    def tracked_verify_items(self, items):
        with vote_lock:
            batcher_rounds.append(len(items))
            vote_ids.update(id(it) for it in items)
        try:
            return verify_items(self, items)
        finally:
            with vote_lock:
                vote_ids.difference_update(id(it) for it in items)

    def vote_rows(items):
        with vote_lock:
            return sum(id(it) in vote_ids for it in items)

    verifier = default_verifier()
    rec = RoundRecorder(torch, verifier, tag=vote_rows)
    ledger = DispatchLedger()
    sched = VerifyScheduler(ledger=ledger, metrics=SchedulerMetrics(Registry("smoke_chaos")))
    stages, checked, loop = [], {}, {}
    profile_dir = tempfile.mkdtemp(prefix="smoke-chaos-profile-")

    def low():
        return min(h.height() for h in runner.live_nodes())

    def states():
        return [(h.name, h.alive, h.height(), h.cs.rs.round, str(h.cs.rs.step),
                 len(h.switch.peers)) for h in handles]

    end = time.perf_counter() + CHAOS_WALL_S

    async def bounded(aw, what, walled=True):
        limit = min(CHAOS_TIMEOUT_S, end - time.perf_counter()) if walled else CHAOS_TIMEOUT_S
        try:
            return await asyncio.wait_for(aw, max(0.0, limit))
        except asyncio.TimeoutError:
            raise AssertionError(f"chaos mesh: {what} took over {limit:.1f} s (each wait "
                                 f"{CHAOS_TIMEOUT_S} s, the mesh {CHAOS_WALL_S} s); "
                                 f"(node, alive, height, round, step, peers) {states()}") from None

    async def wait_all(height):
        print(f"chaos mesh: waiting for height {height}; {states()}", file=sys.stderr,
              flush=True)
        await bounded(asyncio.gather(*(h.cs.wait_for_height(height, timeout=CHAOS_TIMEOUT_S)
                                       for h in runner.live_nodes())), f"height {height}")

    async def one_chain(upto):
        for k in range(1, upto + 1):
            hashes = await chain_hashes(handles, k)
            assert len(hashes) == 1, f"chaos mesh: {len(hashes)} chains at height {k}"
            checked[k] = True

    async def drive():
        await sched.start()
        await start_mesh(handles)
        try:
            t0, h0 = time.perf_counter(), 0
            # the storm's loop profile, sampled on this (the loop's) thread
            capture = ProfileCapture(profile_dir)
            capture.start(label="storm", device=False)
            sampler = capture._sampler
            try:
                await bounded(runner.run(until_height=CHAOS_STORM_HEIGHT,
                                         timeout=CHAOS_TIMEOUT_S), "the storm")
            finally:
                loop.update(session=capture.stop(), stacks=sampler.stacks)
            stages.append(("storm", time.perf_counter() - t0, low() - h0))
            await one_chain(low())
            before = max(h.height() for h in handles)
            await runner.net.partition("split", [names[: n_vals // 2], names[n_vals // 2:]])
            for h in handles:
                for peer_id in h.switch.peers:
                    other = runner.net._name_for(peer_id)
                    assert runner.net.allowed(h.name, other), (h.name, other)
            # the height in flight still commits where its precommits had
            # arrived, and a node that lags inside its half catches up to
            # it; a half that holds +2/3 prevotes from before the split
            # goes on to precommit inside it, its heights standing: wait
            # until each half stands at one height and no node's height,
            # round or step has moved for CHAOS_SETTLE_S (a half that
            # lacks the other's votes ends stuck at one step, at most one
            # propose timeout on). A precommit of the height in flight that
            # crossed before the split can still be relayed inside a half
            # without moving its receiver's step, so the votes each node
            # holds, and those queued toward it, count as movement too
            halves = [handles[: n_vals // 2], handles[n_vals // 2:]]

            def standing():
                out = []
                for h in handles:
                    rs, votes = h.cs.rs, ()
                    if rs.votes is not None:
                        votes = tuple(None if vs is None else vs.bit_array()._bits
                                     for vs in (rs.votes.prevotes(rs.round),
                                                rs.votes.precommits(rs.round)))
                    batcher = h.switch.reactors["consensus"].vote_batcher
                    out.append((h.height(), rs.round, str(rs.step), votes,
                                h.cs.peer_msg_queue.qsize(), h.cs.internal_msg_queue.qsize(),
                                len(batcher._queue) + len(batcher._inflight)))
                return out

            def held():
                # (node, height, prevotes, precommits) held for its round
                return [(h.name, st[0]) + tuple(bin(b or 0).count("1") for b in st[3])
                        for h, st in zip(handles, standing())]

            t0 = time.perf_counter()
            seen, polls = standing(), 0
            moved = {"steps": 0.0, "any": 0.0}  # when each last moved, s after the split
            deadline = min(t0 + CHAOS_TIMEOUT_S, end)
            while (polls * CHAOS_SETTLE_POLL_S < CHAOS_SETTLE_S
                   or any(len({h.height() for h in half}) > 1 for half in halves)):
                await asyncio.sleep(CHAOS_SETTLE_POLL_S)
                now = standing()
                polls = polls + 1 if now == seen else 0
                if now != seen:
                    moved["any"] = time.perf_counter() - t0
                    if [x[:3] for x in now] != [x[:3] for x in seen]:
                        moved["steps"] = moved["any"]
                seen = now
                assert time.perf_counter() < deadline, ("the partition never settled", states(),
                                                        held())
            stages.append(("settled", time.perf_counter() - t0, moved, held()))
            stalled = [h.height() for h in handles]
            assert max(stalled) <= before + 1, ("an even partition committed", before, stalled)
            await asyncio.sleep(CHAOS_STALL_S)
            assert [h.height() for h in handles] == stalled, (
                "an even partition committed", stalled, states(), held())
            t0, h0 = time.perf_counter(), low()
            await runner.net.heal("split")
            await wait_all(max(stalled) + CHAOS_HEAL_HEIGHTS)
            stages.append(("partition healed", time.perf_counter() - t0, low() - h0))
            stages.append(("stalled", stalled))
            await one_chain(low())
            t0, h0 = time.perf_counter(), low()
            await bounded(runner._execute(Step(action="kill", params={"node": "n3"})),
                          "the kill")
            await wait_all(h0 + CHAOS_KILL_HEIGHTS)
            stages.append(("n3 killed", time.perf_counter() - t0, low() - h0))
            t0, h0 = time.perf_counter(), low()
            await bounded(runner._execute(Step(action="restart", params={"node": "n3"})),
                          "the restart")
            target = max(h.height() for h in handles) + CHAOS_KILL_HEIGHTS
            await wait_all(target)
            stages.append(("n3 restarted", time.perf_counter() - t0, low() - h0))
            await one_chain(target)
        finally:
            await bounded(stop_mesh(handles), "stopping the mesh", walled=False)
            await sched.stop()

    gc.collect()
    VoteBatcher._verify_items = tracked_verify_items
    set_default_scheduler(sched)
    rec.install()
    ops.reset_launches()
    try:
        run_bounded(drive())
        torch.cuda.synchronize()
        launches = ops.kernel_launches()
    finally:
        rec.remove()
        set_default_scheduler(None)
        VoteBatcher._verify_items = verify_items
        shutil.rmtree(profile_dir, ignore_errors=True)
    entries = runner.net.trace.entries
    links = {"drop": sum(1 for e in entries if len(e) > 3 and e[3] == "drop"),
             "duplicate": sum(e[6] for e in entries if len(e) > 6 and e[3] == "deliver"),
             "deliver": sum(1 for e in entries if len(e) > 3 and e[3] == "deliver")}
    return {"handles": handles, "stages": stages, "checked": sorted(checked), "rec": rec,
            "ledger": ledger.entries(), "launches": launches, "links": links,
            "batcher_rounds": batcher_rounds, "loop": loop,
            "min_batch": verifier._min_device_batch, "verifier": verifier, "device": device}


def guard_probe(smi: str):
    """Part (d) of phase 10: the backend guard on the card: the default
    probe (a child putting one tensor operation on cuda:0), meta_block, and
    a probe of a child that hangs, killed at GUARD_HANG_S."""
    import torch

    from tendermint_tpu_torch.chaos import backend_guard

    t0 = time.perf_counter()
    st = backend_guard.probe_backend()
    probe_s = time.perf_counter() - t0
    assert st.available and st.kind == "ok" and st.backend == "cuda", st.as_dict()
    meta = backend_guard.meta_block(live=True)
    assert meta["backend"] == "cuda" and meta["device_count"] == torch.cuda.device_count()
    assert meta["device_name"] == torch.cuda.get_device_name(0), meta
    t0 = time.perf_counter()
    hang = backend_guard.probe_backend(
        probe_cmd=[sys.executable, "-c", "import time; time.sleep(600)"], timeout_s=GUARD_HANG_S)
    hang_s = time.perf_counter() - t0
    assert not hang.available and hang.kind == "timeout" and hang.rc == 124, hang.as_dict()
    assert hang_s < GUARD_HANG_S + 5.0, hang_s
    print(f"main path: bulk rest (d): backend guard: probe_backend() {json.dumps(st.as_dict())} "
          f"in {probe_s:.2f} s (a child process: torch, one tensor operation on cuda:0, "
          f"synchronized); meta_block(live=True) {json.dumps(meta)}; a hanging child "
          f"{json.dumps(hang.as_dict())} after {hang_s:.2f} s (bound {GUARD_HANG_S} s) | {smi}")


def bulk_rest_phase(torch, ops, host, smi, rng, src, vkeys,
                    n_clients: int = SWARM_CLIENTS, chaos_vals: int = CHAOS_VALIDATORS):
    """Phase 10: the light-client serving plane at full width over phase
    9's chain (serve_swarm), the swarm's attack evidence through two pools
    over p2p (gossip_evidence), the chaos mesh (chaos_mesh) and the backend
    guard (guard_probe). Checks each part, holds every recorded round
    against the plain version (check_recorded), kernel 2's tables of the
    mesh's new keys against theirs, and prints the figures. Returns the
    launches of the parts, summed per kernel, and the checks' max_abs_err
    per kernel."""
    from tendermint_tpu_torch.ops import ed25519_batch as ed
    from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence, decode_evidence

    n_vals = len(vkeys)
    tip = src.heights - 1
    now_ns = CATCHUP_T0 + (src.heights + 60) * 10**9
    total, errs = {}, {}

    def add(launches, chk):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        for k, v in chk["err"].items():
            errs[k] = max(errs.get(k, 0), v)

    def shown(launches):
        return json.dumps({k: v for k, v in launches.items() if v})

    # (a) the serving plane
    a = serve_swarm(torch, ops, src, vkeys, n_clients, now_ns)
    st, launches = a["stats"], a["launches"]
    assert st["synced"] == st["n_clients"] == n_clients, (st["synced"], n_clients)
    assert st["target_height"] == tip, st["target_height"]
    assert st["cache"]["hit_rate"] > 0.9, st["cache"]
    assert st["verify"]["dedup_rate"] > 0.99, st["verify"]
    assert st["verify"]["executed"] <= 8, st["verify"]
    device_rounds = st["registry_delta"]["device_dispatch_count"]
    assert device_rounds + st["scheduler_rounds"] < n_clients / 10, (device_rounds, st)
    sc = st["scenarios"]
    assert sc["divergent_witness"]["attack_detected"], sc
    assert sc["divergent_witness"]["evidence_pool_size"] >= 1, sc
    assert sc["evidence_is_light_attack"], sc
    assert sc["forged_header"]["synced"] and sc["forged_header"]["forged_witness_removed"], sc
    assert launches["verify_prehashed_table"] > 0, "bulk rest (a): kernel 3 not launched"
    chk = check_recorded(torch, ed, host, a["rec"], rng, 511, "bulk rest (a)")
    add(launches, chk)
    serve_rounds = [r for r in ledger_rounds(a["ledger"]) if "lightserve" in r[0]]
    dispatched = [(d["rows"], d["bucket"], d["tier"]) for d in a["rec"].dispatches]
    big = launches.get("verify_prehashed_bigcache", 0)
    print(f"main path: bulk rest (a): {n_clients} LightClients synced heights 1 -> {tip} of "
          f"the {n_vals}-validator chain through one LightServePlane (ServeVerifier on the "
          f"scheduler's lightserve lane); cache {json.dumps(st['cache'])}; verify "
          f"{json.dumps(st['verify'])}; scheduler rounds {st['scheduler_rounds']} "
          f"({st['scheduler_coalesced_rounds']} coalesced), device dispatches "
          f"{device_rounds}; lightserve rounds (classes, rows, bucket, merged submissions) "
          f"{serve_rounds}; every round of the part (the scenarios' included) "
          f"{ledger_rounds(a['ledger'])}; device rounds (rows, bucket, tier) {dispatched}; "
          f"big tier {'reached' if big else 'not reached (no coalesced round of 512 rows)'}; "
          f"divergent witness: LightClientAttackEvidence raised, accepted by the honest "
          f"node's pool; forged header: the witness removed, the client synced; every "
          f"round equal to the plain version ({chk['small_rounds']} small-tier rounds' "
          f"{chk['small_rows']} rows together, {chk['windows']} big-tier at their shape), "
          f"{chk['sampled']} seeded rows to the host oracle (tolerance: exact); launches "
          f"{shown(launches)} | {smi}")
    print(f"time: bulk rest (a): {st['clients_per_s']} clients/s ({st['wall_s']} s for "
          f"{n_clients} clients), cache hit rate {st['cache']['hit_rate']}, dedup rate "
          f"{st['verify']['dedup_rate']}, {st['verify']['executed']} executed verifications, "
          f"device rounds per {n_clients} clients {device_rounds}; kernel wrapper calls on "
          f"the card {a['rec'].busy_ms():.2f} ms | {smi}")

    # (b) attack evidence through two pools over p2p
    ev = decode_evidence(bytes.fromhex(sc["divergent_witness"]["evidence_hex"]))
    assert isinstance(ev, LightClientAttackEvidence)
    b = gossip_evidence(torch, ops, src, vkeys, ev)
    v = b["verdicts"]
    assert v["light-client attack"][0] == "accepted", v
    assert b["b_pending"] == [ev.encode()], "bulk rest (b): the second pool's pending list"
    assert v["attack, the heaviest third flipped"][0].startswith("rejected"), v
    assert v["duplicate vote"][0] == "accepted", v
    assert "invalid signature" in v["duplicate vote, a signature flipped"][0], v
    assert all(n < 8 for n in v["duplicate vote"][2]), v["duplicate vote"]
    launches = b["launches"]
    assert launches["verify_prehashed_table"] > 0, "bulk rest (b): kernel 3 not launched"
    evidence_rounds = [e for e in b["ledger"] if "evidence" in e["rows"]]
    assert evidence_rounds, "bulk rest (b): no round on the evidence lane"
    chk = check_recorded(torch, ed, host, b["rec"], rng, 511, "bulk rest (b)")
    add(launches, chk)
    desc = "; ".join(f"{k}: {r[0][:90]} ({r[1] * 1e3:.2f} ms, rounds of {r[2]} rows)"
                     for k, r in v.items())
    print(f"main path: bulk rest (b): the swarm's LightClientAttackEvidence (common height "
          f"{ev.common_height}, {n_vals} signatures) through the honest node's "
          f"EvidencePool (default_dispatch(\"evidence\"), {len(evidence_rounds)} evidence-lane "
          f"rounds (classes, rows, bucket, merged submissions) {ledger_rounds(evidence_rounds)}), "
          f"gossiped by its EvidenceReactor over encrypted p2p to a second node whose pool "
          f"verified and accepted it ({b['gossip_s'] * 1e3:.2f} ms, the same bytes); {desc}; "
          f"the flipped copy of {len(b['tampered'])} signatures (more than 1/3 of the power) "
          f"rejected; the copy with one signature flipped "
          f"{v['attack, one signature flipped'][0][:60]} (reported, not checked: both "
          f"packages' tally counts the valid signatures alone, and {n_vals - 1} of them hold "
          f"more than 2/3; ROADMAP.md section C); the duplicate vote's "
          f"2 rows are under min_device_batch (8): checked on the host oracle, as designed; "
          f"every round equal to the plain version, {chk['sampled']} seeded rows to the "
          f"host oracle (tolerance: exact); launches {shown(launches)} | {smi}")

    # (c) the chaos mesh
    c = chaos_mesh(torch, ops, chaos_vals)
    launches = c["launches"]
    assert launches["verify_prehashed_table"] > 0, "bulk rest (c): kernel 3 not launched"
    assert launches["neg_pubkey_table"] > 0, "bulk rest (c): kernel 2 not launched"
    small = [d for d in c["rec"].dispatches if d["tier"] == "small"]
    vote_dispatches = [d for d in small if d["tag"]]
    other_dispatches = [d for d in small if not d["tag"]]
    assert vote_dispatches, "bulk rest (c): no VoteBatcher round reached the card"
    chk = check_recorded(torch, ed, host, c["rec"], rng, 511, "bulk rest (c)")
    # kernel 2's tables of the mesh's keys, as the table cache holds them
    cache = c["verifier"]._small
    keys = [h.cs.priv_validator.get_pub_key().data for h in c["handles"]]
    rows_t = torch.tensor([cache._idx[k] for k in keys], dtype=torch.int64,
                          device=cache.tables.device)
    pk = torch.tensor([list(k) for k in keys], dtype=torch.uint8, device=cache.tables.device)
    plain_t, plain_v = ed.neg_pubkey_table_plain(pk)
    e2 = max(max_abs_err(cache.tables[rows_t], plain_t), max_abs_err(cache.valid[rows_t], plain_v))
    assert e2 == 0, "bulk rest (c): kernel 2's tables of the mesh's keys != plain"
    chk["err"]["neg_pubkey_table"] = e2
    add(launches, chk)
    under = sum(1 for items, _ in c["rec"].rounds if len(items) < c["min_batch"])
    vote_rounds = sum(1 for t in c["rec"].round_tags if t)
    stages = {s[0]: s[1:] for s in c["stages"]}
    per_h = "; ".join(f"{name} {s * 1e3 / max(1, n):.1f} ms a height ({n} heights, "
                      f"{s * 1e3:.1f} ms)" for name, (s, n) in
                      ((k, stages[k]) for k in ("storm", "partition healed", "n3 killed",
                                                 "n3 restarted")))
    print(f"main path: bulk rest (c): chaos mesh of {chaos_vals} validators over encrypted "
          f"p2p (tests/torch_chaos_harness.py, device {c['device']}, full mesh), seed "
          f"{CHAOS_SEED}: "
          f"storm {json.dumps(CHAOS_STORM)} with n3's clock at {CHAOS_SKEW}x to height "
          f"{CHAOS_STORM_HEIGHT}; an even split committed nothing for {CHAOS_STALL_S} s "
          f"(heights {stages['stalled'][0]}; settled {stages['settled'][0]:.2f} s after the "
          f"split, heights, rounds and steps last moving at {stages['settled'][1]['steps']:.2f} "
          f"s, held votes and queues at {stages['settled'][1]['any']:.2f} s; (node, height, "
          f"prevotes, precommits) {stages['settled'][2]}), healed; n3 killed "
          f"and restarted; one chain at "
          f"every height 1-{c['checked'][-1]}; links: {c['links']['drop']} messages dropped, "
          f"{c['links']['duplicate']} duplicated of {c['links']['deliver']} delivered; "
          f"{len(c['batcher_rounds'])} VoteBatcher rounds of {sum(c['batcher_rounds'])} votes, "
          f"{len(c['rec'].rounds)} verifier rounds ({vote_rounds} with VoteBatcher rows, the "
          f"rest LastCommit and proposal checks), {under} under min_device_batch "
          f"({c['min_batch']}) on the host oracle; kernel 3 launches {len(vote_dispatches)} "
          f"on rounds with VoteBatcher rows, "
          f"{len(other_dispatches)} on the others; kernel "
          f"2's tables of the {chaos_vals} new keys equal the plain version; every round "
          f"equal to the plain version ({chk['small_rounds']} small-tier rounds' "
          f"{chk['small_rows']} rows together), {chk['sampled']} seeded rows to the host "
          f"oracle (tolerance: exact); launches {shown(launches)} | {smi}")
    busy = c["rec"].busy_ms()
    print(f"time: bulk rest (c): {per_h}; kernel wrapper calls on the card {busy:.2f} ms | {smi}")
    lp, shares = c["loop"]["session"]["loop_profile"], loop_shares(c["loop"]["stacks"])
    assert lp["samples"] > 0 and shares["samples"] == lp["samples"], (lp["samples"], shares)
    top = [(t["count"], " < ".join(t["stack"][:3])) for t in lp["top_stacks"][:3]]
    print(f"trace: bulk rest (c): the storm's loop profile (ProfileCapture, device=False, armed "
          f"on the mesh's event-loop thread; {lp['samples']} samples at "
          f"{c['loop']['session']['loop_sample_interval_s']} s over "
          f"{c['loop']['session']['duration_s']} s): shares of the samples by the directory of "
          f"their innermost port frame {json.dumps(shares['shares'])}; top stacks (samples, "
          f"innermost frames) {top} | {smi}")

    # (d) the backend guard on the card
    guard_probe(smi)
    return total, errs


# --- phase 11: the verify service and the sequencer plane ---------------------

SERVICE_WINDOW = 39  # commits of phase 9's chain in the window (blocksync/pool.py's most)
SERVICE_WINDOW_BAD = 20  # the window's commit whose heaviest third is tampered
SERVICE_TURNS = 10  # turns of one 150-row commit, through the service and in-proc
SERVICE_PINGS = 200  # PING frames timed on a raw connection
SERVICE_STOP_S = 5.0  # the bound on a stop with clients attached
SERVICE_TIMEOUT_S = 120  # a bound on each wait of the phase
# the service verifier's min_device_batch: the 3-validator net's vote rounds
# (2 rows a node a step) reach the card; the commits and the window are far above
SERVICE_MIN_BATCH = 2
SEQ_VALIDATORS = 3  # the sequencer and two followers (tests/torch_sequencer_net.py)
SEQ_UPGRADE = 3  # the BFT height the net hands off at
SEQ_V2_BLOCKS = 10  # BlockV2s each follower applies past it
SEQ_BLOCK_INTERVAL = 0.1  # the sequencer's production interval, seconds

# The third client: a child process importing only the port (JAX made to
# fail), attached to the service. It reads SUBMIT frames (u32 length +
# payload, the wire's own) from the file named by argv[2], waits for "go" on
# stdin, submits them all at once, prints their verdict bitmaps; then waits
# for the service to go away and come back, prints its ipc_stats, submits
# the first frame again and prints that bitmap. One JSON object a line.
SERVICE_CHILD = r'''
import asyncio, json, os, struct, sys, time
sys.modules["jax"] = None
sys.path.insert(0, os.environ["SMOKE_ROOT"])
import numpy as np
from tendermint_tpu_torch.parallel.verify_service import (
    RemoteVerifyScheduler, _Cursor, _HDR, decode_submit)


def frames(path):
    data, off = open(path, "rb").read(), 0
    while off < len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        cur = _Cursor(data[off + 4:off + 4 + n])
        cur.take(_HDR.size)
        yield decode_submit(cur)
        off += 4 + n


def say(**kw):
    print(json.dumps(kw), flush=True)


async def until(cond, limit):
    end = time.monotonic() + limit
    while not cond() and time.monotonic() < end:
        await asyncio.sleep(0.01)
    return cond()


async def main(sock, path):
    subs = list(frames(path))
    remote = RemoteVerifyScheduler(sock, retry_base=0.02, origin="smoke-child")
    await remote.start()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] == "tendermint_tpu")
    say(attached=await until(lambda: remote.connected, 60), reference_modules=leaked)
    await asyncio.get_running_loop().run_in_executor(None, sys.stdin.readline)

    async def one(items, klass):
        t0 = time.perf_counter()
        v = await remote.submit(items, klass)
        return np.packbits(np.asarray(v, dtype=np.uint8)).tobytes().hex(), time.perf_counter() - t0

    got = await asyncio.gather(*(one(i, k) for i, k in subs))
    say(bitmaps=[g[0] for g in got], rtt_s=[g[1] for g in got], stats=remote.ipc_stats())
    say(lost=await until(lambda: not remote.connected, 60))
    say(reattached=await until(lambda: remote.connected, 60), stats=remote.ipc_stats())
    bitmap, rtt = await one(*subs[0])
    say(again=bitmap, rtt_s=rtt, stats=remote.ipc_stats())
    await remote.stop()


asyncio.run(main(sys.argv[1], sys.argv[2]))
'''


def service_phase(torch, ops, host, smi, rng, vset, chain_id, commits, src, device="cuda"):
    """Phase 11: one ServiceThread owns the card and serves three clients
    over a Unix socket: two RemoteVerifySchedulers in this process and one
    in a child process (SERVICE_CHILD). (a) Each submits phase 3's
    150-validator commits at once, one of them also a SERVICE_WINDOW-commit
    window of phase 9's chain (the raw rows, then verify_commits_light
    through its classed adapter): verdicts bit-identical to an in-proc
    VerifyScheduler's on the process verifier; the service's tenants,
    rounds against submissions, round trips. (b) The service stopped with
    the three attached (inside SERVICE_STOP_S), a submission while it is
    down on the client's own verifier with the degrade event "service
    unreachable", a restart on the same path that every client re-attaches
    to. (c) The BFT -> sequencer upgrade with two followers over encrypted
    p2p (tests/torch_sequencer_net.py), the process default scheduler a
    RemoteVerifyScheduler to the service: the votes before it and the
    followers' secp_recover rounds after it cross the socket. Launch counts
    zeroed before each part and read after it; every round of the service's
    verifier held against the plain version (check_recorded), its kernel 2
    and kernel 5 tables against theirs. Returns the launches summed per
    kernel and the checks' max_abs_err per kernel."""
    import shutil
    import tempfile
    from collections import Counter

    import numpy as np

    from tendermint_tpu_torch import obs
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics
    from tendermint_tpu_torch.obs.ledger import DispatchLedger
    from tendermint_tpu_torch.ops import ed25519_batch as ed
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.parallel.verify_service import (
        MSG_PING, MSG_PONG, RemoteVerifyScheduler, ServiceThread, _HDR, encode_submit,
        read_frame, write_frame)
    from tests.torch_sequencer_net import build_upgrade_net, run_upgrade

    n_vals = len(vset.validators)
    commit_items = [[it for it in vset._gather_items(chain_id, c, True)[0]]
                    for _, c in commits]
    vset9 = src.state_store.load_validators(1)
    window = []
    for h in range(1, SERVICE_WINDOW + 1):
        block, commit = src.bs.load_block(h), src.bs.load_block(h + 1).last_commit
        if h == SERVICE_WINDOW_BAD:
            commit = tampered_commit(commit, heaviest_third(vset9))
        window.append((BlockID(block.hash(), block.make_part_set().header), h, commit))
    window_items = [it for _, h, c in window
                    for it in vset9._gather_items(src.chain_id, c, True)[0]]
    want_window = [h != SERVICE_WINDOW_BAD for h in range(1, SERVICE_WINDOW + 1)]

    tmp = tempfile.mkdtemp(prefix="smk")
    sock = os.path.join(tmp, "v.sock")
    if len(sock.encode()) > 100:  # a UDS address holds 107 bytes
        shutil.rmtree(tmp)
        tmp = os.path.relpath(tempfile.mkdtemp(prefix=".smk", dir=ROOT))
        sock = os.path.join(tmp, "v.sock")
    frames_path = os.path.join(tmp, "commits.bin")
    with open(frames_path, "wb") as f:
        for k, items in enumerate(commit_items):
            payload = encode_submit(k + 1, items, "consensus")
            f.write(len(payload).to_bytes(4, "big") + payload)

    svc_verifier = bv.BatchVerifier(device=device, min_device_batch=SERVICE_MIN_BATCH)
    ledger = DispatchLedger()

    def service():
        sched = VerifyScheduler(verifier=svc_verifier, ledger=ledger,
                                metrics=SchedulerMetrics(Registry("smoke_service")))
        svc = ServiceThread(sock, device=device, scheduler=sched)
        svc.start()
        return svc

    rec = RoundRecorder(torch, svc_verifier)
    rec.install()
    local = bv.default_verifier()  # the clients' own verifier, and the in-proc scheduler's
    inproc = VerifyScheduler(verifier=local, ledger=DispatchLedger(),
                             metrics=SchedulerMetrics(Registry("smoke_service_inproc")))
    tracer = obs.Tracer(enabled=True)
    total, errs, out = {}, {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    svc = service()
    child = subprocess.Popen(
        [sys.executable, "-c", SERVICE_CHILD, sock, frames_path],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, SMOKE_ROOT=ROOT))

    def child_line() -> dict:
        line = child.stdout.readline()
        assert line, f"verify service: the child client exited ({child.poll()})"
        return json.loads(line)

    async def bounded(aw, what):
        try:
            return await asyncio.wait_for(aw, SERVICE_TIMEOUT_S)
        except asyncio.TimeoutError:
            raise AssertionError(f"verify service: {what} took over "
                                 f"{SERVICE_TIMEOUT_S} s") from None

    async def until(cond, what):
        end = time.monotonic() + SERVICE_TIMEOUT_S
        while not cond():
            assert time.monotonic() < end, f"verify service: {what}"
            await asyncio.sleep(0.01)

    def bits(v) -> str:
        return np.packbits(np.asarray(v, dtype=np.uint8)).tobytes().hex()

    async def drive():
        nonlocal svc
        loop = asyncio.get_running_loop()
        await inproc.start()
        a = RemoteVerifyScheduler(sock, verifier=local, tracer=tracer, retry_base=0.02,
                                  origin="smoke-a")
        b = RemoteVerifyScheduler(sock, verifier=local, tracer=tracer, retry_base=0.02,
                                  origin="smoke-b")
        for r in (a, b):
            await r.start()
        try:
            await until(lambda: a.connected and b.connected, "the in-process clients attach")
            hello = await loop.run_in_executor(None, child_line)
            assert hello["attached"] and not hello["reference_modules"], hello

            # (a) three tenants' commits at once, then the window
            rtts = []

            async def timed(r, items, klass):
                t0 = time.perf_counter()
                v = await r.submit(items, klass)
                rtts.append(time.perf_counter() - t0)
                return bits(v)

            ops.reset_launches()
            t0 = time.perf_counter()
            # one commit alone first: its round is the small tier (kernel 2
            # builds the keys' tables, kernel 3 verifies); the burst after
            # it coalesces
            first = await bounded(timed(a, commit_items[0], "consensus"), "the first commit")
            child.stdin.write("go\n")
            child.stdin.flush()
            mine = await bounded(asyncio.gather(
                *(timed(r, items, "consensus") for r in (a, b) for items in commit_items)),
                "the commits")
            theirs = await loop.run_in_executor(None, child_line)
            win_bits = await bounded(timed(a, window_items, "blocksync"), "the window")
            win_verdicts = await bounded(loop.run_in_executor(
                None, vset9.verify_commits_light, src.chain_id, window, a.classed("blocksync")),
                "verify_commits_light through the service")
            out["a_s"] = time.perf_counter() - t0
            launches = ops.kernel_launches()
            add(launches)
            out["a_launches"] = {k: v for k, v in launches.items() if v}
            for name in ("neg_pubkey_table", "verify_prehashed_table",
                         "neg_pubkey_bigtable", "verify_prehashed_bigcache"):
                assert launches[name] > 0, f"verify service (a): {name} not launched"
            ref = [bits(await inproc.submit(items, "consensus")) for items in commit_items]
            ref_win = bits(await inproc.submit(window_items, "blocksync"))
            assert first == ref[0], "verify service (a): the first commit's verdicts"
            assert mine == ref * 2 and theirs["bitmaps"] == ref, "verify service (a): verdicts"
            assert win_bits == ref_win, "verify service (a): the window's rows"
            assert win_verdicts == want_window, win_verdicts
            stats = [r.ipc_stats() for r in (a, b)] + [theirs["stats"]]
            assert all(s["degrades"] == 0 for s in stats), stats
            tenants = {k: dict(v) for k, v in svc.server.client_stats.items()}
            assert len(tenants) == 3 and all(v["rows"] > 0 for v in tenants.values()), tenants
            out.update(rtts=rtts + theirs["rtt_s"], stats=stats, tenants=tenants,
                       entries=list(ledger.entries()))

            # the IPC alone (PING frames) and one commit's turns
            reader, writer = await asyncio.open_unix_connection(sock)
            pings = []
            for k in range(SERVICE_PINGS):
                t1 = time.perf_counter()
                write_frame(writer, _HDR.pack(MSG_PING, k) + b"x" * 32)
                await writer.drain()
                frame = await read_frame(reader)
                pings.append(time.perf_counter() - t1)
                assert _HDR.unpack(frame[:_HDR.size]) == (MSG_PONG, k)
            writer.close()
            turns = {"service": [], "in-proc": []}
            for k in range(SERVICE_TURNS):
                items = commit_items[k % len(commit_items)]
                for name, r in (("service", a), ("in-proc", inproc)):
                    t1 = time.perf_counter()
                    await r.submit(items, "consensus")
                    turns[name].append((time.perf_counter() - t1) * 1e3)
            out.update(pings=pings, turns=turns)

            # (b) stop with the three attached, degrade, restart
            thread = svc._thread
            t1 = time.perf_counter()
            svc.stop()
            out["stop_s"] = time.perf_counter() - t1
            assert out["stop_s"] < SERVICE_STOP_S and not thread.is_alive(), out["stop_s"]
            await until(lambda: not a.connected and not b.connected, "the clients see it go")
            lost = await loop.run_in_executor(None, child_line)
            assert lost["lost"], lost
            ops.reset_launches()
            down = bits(await bounded(a.submit(commit_items[0], "consensus"), "degraded"))
            launches = ops.kernel_launches()
            add(launches)
            assert down == ref[0], "verify service (b): degraded verdicts"
            assert launches["verify_prehashed_table"] > 0, \
                "verify service (b): the client's verifier did not launch kernel 3"
            events = [e.to_json()["fields"] for e in tracer.records()
                      if e.name == "verify_service.degrade"]
            assert events and events[-1]["reason"] == "service unreachable", events
            out.update(b_launches={k: v for k, v in launches.items() if v},
                       degrade=events[-1], degrade_device=str(local.device))
            svc = service()
            await until(lambda: a.connected and b.connected, "the clients re-attach")
            back = await loop.run_in_executor(None, child_line)
            again = await loop.run_in_executor(None, child_line)
            assert back["reattached"] and again["again"] == ref[0], (back, again)
            out["reconnects"] = [r.ipc_stats()["reconnects"] for r in (a, b)] + [
                again["stats"]["reconnects"]]
            assert out["reconnects"] == [2, 2, 2], out["reconnects"]

            # (c) the upgrade behind the service
            seq0 = max((e["seq"] for e in ledger.entries()), default=-1)
            set_default_scheduler(b)
            ops.reset_launches()
            t1 = time.perf_counter()
            nodes = build_upgrade_net(SEQ_VALIDATORS, SEQ_UPGRADE,
                                      block_interval=SEQ_BLOCK_INTERVAL)
            res = await run_upgrade(nodes, SEQ_UPGRADE, SEQ_V2_BLOCKS,
                                    timeout=SERVICE_TIMEOUT_S)
            out["c_s"] = time.perf_counter() - t1
            launches = ops.kernel_launches()
            add(launches)
            entries = [e for e in ledger.entries() if e["seq"] > seq0]
            out.update(upgrade=res, c_launches={k: v for k, v in launches.items() if v},
                       c_entries=entries, c_stats=b.ipc_stats())
            assert res["bft_heights"] == [SEQ_UPGRADE] * SEQ_VALIDATORS, res
            assert all(h >= SEQ_UPGRADE + SEQ_V2_BLOCKS for h in res["follower_v2"]), res
            assert res["signers"] == [res["sequencer_address"]] * (SEQ_VALIDATORS - 1), res
            assert launches["verify_prehashed_table"] > 0, \
                "verify service (c): no vote round reached kernel 3"
            assert sum(e["requested"] for e in entries if e["engine"] == "secp_recover") \
                >= (SEQ_VALIDATORS - 1) * SEQ_V2_BLOCKS, entries
            assert b.ipc_stats()["degrades"] == out["c_stats"]["degrades"] == 0

            # the end: a stop with the clients still attached
            thread = svc._thread
            t1 = time.perf_counter()
            svc.stop()
            out["stop2_s"] = time.perf_counter() - t1
            assert out["stop2_s"] < SERVICE_STOP_S and not thread.is_alive(), out["stop2_s"]
        finally:
            set_default_scheduler(None)
            for r in (a, b):
                await r.stop()
            await inproc.stop()

    try:
        run_bounded(drive())
        assert child.wait(SERVICE_TIMEOUT_S) == 0, "verify service: the child client failed"
    finally:
        if child.poll() is None:
            child.kill()
        if svc._thread is not None:
            svc.stop()
        rec.remove()
        shutil.rmtree(tmp, ignore_errors=True)

    # every round of the service's verifier against the plain version, its
    # tables against theirs
    chk = check_recorded(torch, ed, host, rec, rng, 511, "verify service")
    errs.update(chk["err"])
    keys = [v.pub_key.data for v in vset.validators]
    for cache, plain, name in ((svc_verifier._small, ed.neg_pubkey_table_plain,
                                "neg_pubkey_table"),
                               (svc_verifier._big, ed.neg_pubkey_bigtable_plain,
                                "neg_pubkey_bigtable")):
        rows_t = torch.tensor([cache._idx[k] for k in keys], dtype=torch.int64,
                              device=cache.tables.device)
        pk = torch.tensor([list(k) for k in keys], dtype=torch.uint8, device=cache.tables.device)
        plain_t, plain_v = plain(pk)
        e = max(max_abs_err(cache.tables[rows_t], plain_t),
                max_abs_err(cache.valid[rows_t], plain_v))
        assert e == 0, f"verify service: {name}'s tables of the {n_vals} keys != plain"
        errs[name] = max(errs.get(name, 0), e)

    def shown(launches):
        return json.dumps({k: v for k, v in launches.items() if v})

    entries = out["entries"]
    sig_rounds = [e for e in entries if e["engine"] == "sig"]
    subs = sum(e["submissions"] for e in sig_rounds)
    rtt = sorted(out["rtts"])
    ping = sorted(out["pings"])

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3

    up = out["upgrade"]
    c_entries = out["c_entries"]
    votes = [e for e in c_entries if e["engine"] == "sig"]
    on_card = sum(1 for e in votes if e["requested"] >= SERVICE_MIN_BATCH)
    recover = [e for e in c_entries if e["engine"] == "secp_recover"]
    print(f"main path: verify service (a): one ServiceThread ({device}, its own "
          f"BatchVerifier, min_device_batch {SERVICE_MIN_BATCH}) serving 3 clients over a "
          f"Unix socket (2 RemoteVerifySchedulers in this process, 1 in a child process "
          f"importing only the port); each submitted phase 3's {len(commit_items)} commits of "
          f"{n_vals} rows at once, client a also the {SERVICE_WINDOW}-commit window of phase "
          f"9's chain ({len(window_items)} rows, commit {SERVICE_WINDOW_BAD} tampered by the "
          f"heaviest third) raw and through verify_commits_light: verdicts bit-identical to "
          f"an in-proc VerifyScheduler's on the process verifier, the window's "
          f"[True]*{SERVICE_WINDOW_BAD - 1} + [False] + [True]*"
          f"{SERVICE_WINDOW - SERVICE_WINDOW_BAD}; tenants {json.dumps(out['tenants'])}; "
          f"{len(sig_rounds)} service rounds for {subs} submissions (classes, rows, bucket, "
          f"merged submissions) {ledger_rounds(sig_rounds)}; launches "
          f"{shown(out['a_launches'])} | {smi}")
    print(f"time: verify service (a): {out['a_s'] * 1e3:.2f} ms for the three clients' "
          f"commits and the window; submit -> verdicts round trips ({len(rtt)}) median "
          f"{pct(rtt, 0.5):.3f} ms, p99 {pct(rtt, 0.99):.3f} ms; ipc_stats "
          f"{json.dumps([{k: s[k] for k in ('rtt_count', 'rtt_sum_s', 'remote_submissions')} for s in out['stats']])}; "
          f"PING round trips ({SERVICE_PINGS}, the IPC alone) median {pct(ping, 0.5):.4f} ms, "
          f"p99 {pct(ping, 0.99):.4f} ms; a {n_vals}-row commit in {SERVICE_TURNS} turns, "
          f"through the service {statistics.median(out['turns']['service']):.3f} ms "
          f"(median; {min(out['turns']['service']):.3f}-{max(out['turns']['service']):.3f}) "
          f"against in-proc {statistics.median(out['turns']['in-proc']):.3f} ms "
          f"({min(out['turns']['in-proc']):.3f}-{max(out['turns']['in-proc']):.3f}); kernel "
          f"wrapper calls on the card {rec.busy_ms():.2f} ms | {smi}")
    print(f"main path: verify service (b): stopped with the 3 clients attached in "
          f"{out['stop_s'] * 1e3:.1f} ms (bound {SERVICE_STOP_S} s), the service thread dead; "
          f"a submission while it was down ran on client a's own verifier "
          f"({out['degrade_device']}), degrade event {json.dumps(out['degrade'])}, verdicts "
          f"equal, launches {shown(out['b_launches'])}; restarted on the same path, every "
          f"client re-attached (reconnects {out['reconnects']}), the child's resubmission "
          f"equal | {smi}")
    print(f"main path: verify service (c): the BFT -> sequencer upgrade "
          f"(tests/torch_sequencer_net.py) of {SEQ_VALIDATORS} validators over encrypted p2p, "
          f"full mesh, node 0 the sequencer and {SEQ_VALIDATORS - 1} followers, the process "
          f"default scheduler a RemoteVerifyScheduler to the service: BFT heights "
          f"{up['bft_heights']} (upgrade at {SEQ_UPGRADE}); the sequencer at V2 height "
          f"{up['sequencer_v2']}, the followers at {up['follower_v2']} "
          f"({[h - SEQ_UPGRADE for h in up['follower_v2']]} BlockV2s applied), every "
          f"follower's last block recovered to the sequencer's address; {len(votes)} "
          f"signature rounds before the upgrade, {on_card} of them of at least "
          f"{SERVICE_MIN_BATCH} rows (on the card), rows a round "
          f"{json.dumps(sorted(Counter(e['requested'] for e in votes).items()))}; "
          f"{len(recover)} secp_recover rounds after it (on the service's host) for "
          f"{sum(e['requested'] for e in recover)} recoveries, recoveries a round "
          f"{json.dumps(sorted(Counter(e['requested'] for e in recover).items()))}; "
          f"{out['c_s']:.2f} s; launches {shown(out['c_launches'])}; the end: stopped again "
          f"with 2 clients attached in {out['stop2_s'] * 1e3:.1f} ms | {smi}")
    print(f"main path: verify service: every round of the service's verifier in the three "
          f"parts equal to the plain version ({chk['windows']} at their shape, "
          f"{chk['small_rounds']} small-tier rounds' {chk['small_rows']} rows together), "
          f"kernel 2's and kernel 5's tables of the {n_vals} keys equal theirs, "
          f"{chk['sampled']} seeded rows to the host oracle (tolerance: exact) | {smi}")
    return total, errs


# --- the event plane: a joining node's events, its tx index, its socket app --

# subscriber (b) takes the txs of the heights past EVENTS_TX_AFTER, subscriber
# (c) one kvstore key of the chain (the mock L2 node's txs are tx-<h>-<i>=v<i>)
EVENTS_TX_AFTER = 100
EVENTS_KEY = "tx-64-1"
EVENTS_QUERIES = {
    "blocks": "tm.event = 'NewBlock'",
    "late_txs": f"tm.event = 'Tx' AND tx.height > {EVENTS_TX_AFTER}",
    "one_key": f"app.key = '{EVENTS_KEY}'",
}
EVENTS_TX_HEIGHT = 64  # the block whose txs the indexer returns in order
EVENTS_BLOCKS_AFTER = 120  # the heights whose block index entries are read back
EVENTS_WAIT_S = 60  # a bound on each wait of the phase
# the node's app: the port's kvstore served by the port's ABCI CLI in a child
# process (the port has no __main__ yet: a parser built by abci.cli.register)
EVENTS_APP = r"""
import argparse, sys
from tendermint_tpu_torch.abci import cli
p = argparse.ArgumentParser()
cli.register(p.add_subparsers(dest="cmd"))
a = p.parse_args(["abci-cli", "kvstore", "--port", "0"])
sys.exit(a.fn(a))
"""


class EventPlane:
    """A joining node's event plane, the reference node's wiring
    (node/node.py:371-381) with its app out of process: the node's ABCI
    client is a SocketClient to the app server on `port`; its BlockExecutor
    publishes to this object, which times each publish_* and hands it to an
    EventBus made on the sync's event loop; an IndexerService over a
    KVIndexer on a SqliteKV in `db_dir` and the three EVENTS_QUERIES
    subscribers hang off that bus, each subscriber drained by a task while
    the sync runs. `split` holds the seconds in the publishes, the
    indexer's writes and the app's socket calls."""

    def __init__(self, port: int, db_dir: str, src):
        from tendermint_tpu_torch.abci.client import SocketClient
        from tendermint_tpu_torch.state.txindex import KVIndexer
        from tendermint_tpu_torch.store.kv import SqliteKV

        split = self.split = {"publish": 0.0, "publishes": 0, "index": 0.0, "app": 0.0,
                              "app_calls": 0, "settle": 0.0}

        class TimedSocketClient(SocketClient):
            async def call(self, method, *args):
                t0 = time.perf_counter()
                try:
                    return await super().call(method, *args)
                finally:
                    split["app"] += time.perf_counter() - t0
                    split["app_calls"] += 1

        class TimedIndexer(KVIndexer):
            def index_tx(self, result):
                t0 = time.perf_counter()
                super().index_tx(result)
                split["index"] += time.perf_counter() - t0

            def index_block(self, height, events):
                t0 = time.perf_counter()
                super().index_block(height, events)
                split["index"] += time.perf_counter() - t0

        self.app = TimedSocketClient(port=port)
        self.kv = SqliteKV(os.path.join(db_dir, "tx_index.db"))
        self.indexer = TimedIndexer(self.kv)
        self.tip = src.heights - 1
        self.last_tx = src.bs.load_block(self.tip).data.txs[-1]
        self.bus = self.service = None
        self.got = {name: [] for name in EVENTS_QUERIES}
        self.cancelled, self._drains = [], []

    async def start(self) -> None:
        from tendermint_tpu_torch.libs.pubsub import Query
        from tendermint_tpu_torch.state.txindex import IndexerService
        from tendermint_tpu_torch.types.event_bus import EventBus

        await self.app.connect()
        self.bus = EventBus()
        self.service = IndexerService(self.indexer, self.bus)
        subs = {name: self.bus.subscribe(f"smoke/{name}", Query(q))
                for name, q in EVENTS_QUERIES.items()}
        await self.service.start()
        self._drains = [asyncio.create_task(self._drain(name, sub))
                        for name, sub in subs.items()]

    async def _drain(self, name, sub) -> None:
        from tendermint_tpu_torch.libs.pubsub import SubscriptionCancelled

        try:
            while True:
                self.got[name].append(await sub.next())
        except SubscriptionCancelled as e:
            self.cancelled.append((name, str(e)))

    async def _timed(self, publish, *args) -> None:
        t0 = time.perf_counter()
        await publish(*args)
        self.split["publish"] += time.perf_counter() - t0
        self.split["publishes"] += 1

    async def publish_new_block(self, block, result_events=None) -> None:
        await self._timed(self.bus.publish_new_block, block, result_events)

    async def publish_new_block_header(self, header) -> None:
        await self._timed(self.bus.publish_new_block_header, header)

    async def publish_tx(self, height, tx_hash, tx, result_events=None) -> None:
        await self._timed(self.bus.publish_tx, height, tx_hash, tx, result_events)

    async def settle(self) -> None:
        """Waits, bounded, until the indexer holds the tip's block and its
        last tx and every subscriber has its messages: IndexerService.stop()
        cancels its drains at once, and events still queued would be lost."""
        from tendermint_tpu_torch.crypto import tmhash

        want = {"blocks": self.tip, "one_key": 1,
                "late_txs": (self.tip - EVENTS_TX_AFTER) * CATCHUP_TXS}
        t0 = time.perf_counter()
        while not (self.indexer.search_blocks(f"block.height={self.tip}") == [self.tip]
                   and self.indexer.get_tx(tmhash.sum(self.last_tx)) is not None
                   and all(len(self.got[k]) >= n for k, n in want.items())):
            assert not self.cancelled, f"event plane: a subscriber was cancelled {self.cancelled}"
            assert time.perf_counter() - t0 < EVENTS_WAIT_S, (
                "event plane: the indexer or a subscriber did not settle",
                {k: len(v) for k, v in self.got.items()})
            await asyncio.sleep(0.01)
        self.split["settle"] = time.perf_counter() - t0

    async def close(self) -> None:
        if self.service is not None:
            await self.service.stop()
        for t in self._drains:
            t.cancel()
        await asyncio.gather(*self._drains, return_exceptions=True)
        await self.app.close()


def abci_cli(port: int, *args: str) -> str:
    """What the port's ABCI CLI prints for one command against the app
    server on `port` (a parser built by abci.cli.register, run in this
    process on a thread joined within EVENTS_WAIT_S); fails on a non-zero
    exit."""
    import contextlib
    import io

    from tendermint_tpu_torch.abci import cli

    p = argparse.ArgumentParser()
    cli.register(p.add_subparsers(dest="cmd"))
    ns = p.parse_args(["abci-cli", *args, "--port", str(port)])
    out, rc = io.StringIO(), []

    def run():
        with contextlib.redirect_stdout(out):
            rc.append(ns.fn(ns))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(EVENTS_WAIT_S)
    assert rc == [0], f"event plane: abci-cli {args} returned {rc} (nothing: no end)"
    return out.getvalue().strip()


def check_index(idx, blocks, tip: int) -> dict:
    """Phase 12's checks of the indexer `idx` after the sync: every tx of
    the chain (`blocks`, height -> Block) from get_tx with its height and
    index, then the searches in the indexer's own query form,
    "type.key=value" (state/txindex.py:126): every tx by its creator in
    (height, index) order, EVENTS_TX_HEIGHT's txs by key, the block index
    past EVENTS_BLOCKS_AFTER. Returns what the report prints."""
    from tendermint_tpu_torch.crypto import tmhash

    all_txs = [(h, i, tx) for h in range(1, tip + 1) for i, tx in enumerate(blocks[h].data.txs)]
    for h, i, tx in all_txs:
        res = idx.get_tx(tmhash.sum(tx))
        assert res is not None and (res.height, res.index, res.tx) == (h, i, tx), (h, i)
    by_creator = [(x.height, x.index, x.tx) for x in idx.search_txs("app.creator=kvstore", 1000)]
    assert by_creator == all_txs, len(by_creator)
    at_height = [(h, i) for h, i, _ in by_creator if h == EVENTS_TX_HEIGHT]
    assert at_height == [(EVENTS_TX_HEIGHT, i) for i in range(CATCHUP_TXS)], at_height
    for i in range(CATCHUP_TXS):
        one = idx.search_txs(f"app.key=tx-{EVENTS_TX_HEIGHT}-{i}")
        assert [(x.height, x.index) for x in one] == [(EVENTS_TX_HEIGHT, i)], i
    late_blocks = {h: idx.search_blocks(f"block.height={h}")
                   for h in range(EVENTS_BLOCKS_AFTER + 1, tip + 2)}
    assert late_blocks == {**{h: [h] for h in range(EVENTS_BLOCKS_AFTER + 1, tip + 1)},
                           tip + 1: []}, late_blocks
    range_form = (idx.search_txs(f"tx.height = {EVENTS_TX_HEIGHT}"),
                  idx.search_blocks(f"block.height > {EVENTS_BLOCKS_AFTER}"))
    return {"txs": len(all_txs), "at_height": len(at_height), "range_form": range_form}


def events_phase(torch, ops, host, smi, rng, src, wall_a: float, operator=None):
    """Phase 12: a joining node catches up with its event plane on. Phase
    9's chain, src, is blocksynced from one honest server over encrypted
    p2p (catchup_sync) by a fresh node, on a process verifier of its own
    (no key tables yet), whose app, the port's kvstore, sits
    behind the ABCI socket in a child process started through the port's
    ABCI CLI (EVENTS_APP), whose BlockExecutor publishes to an EventBus,
    with an IndexerService over a KVIndexer on a SqliteKV and three
    subscribers drained while it syncs (EventPlane). Checks the synced
    chain as phase 9 does, every subscriber's messages, the indexer's tx
    results and searches, the app through the CLI's info and query, and
    every recorded round against its plain version and the host oracle
    (check_recorded). Prints the sync's wall beside phase 9 (a)'s (`wall_a`,
    seconds), its publish and index shares, the socket app's share of
    apply_block, the messages and the launches. Then, with `operator`, it
    hands the synced node (its stores, EventBus, indexer, the app server's
    port) to operator(node) before its teardown: the child app is killed
    after it, pass or fail. Returns the launches, the checks' max_abs_err
    per kernel and what operator returned."""
    import select
    import shutil
    import tempfile

    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.crypto import tmhash
    from tendermint_tpu_torch.ops import ed25519_batch as ed

    tip = src.heights - 1
    n_vals = len(src.state.validators.validators)
    blocks = {h: src.bs.load_block(h) for h in range(1, tip + 2)}
    want_app = {h: blocks[h + 1].header.app_hash for h in range(1, tip + 1)}
    tmp = tempfile.mkdtemp(prefix="smoke-events-")
    # a joining node is a fresh process whose verifier holds no key tables
    # (phase 9's built the 150 keys' tables): the phase runs on a new
    # process verifier, so kernels 2 and 5 build them again
    kept, bv._default = bv._default, None
    child = plane = None
    try:
        bv.default_verifier("cuda")
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", EVENTS_APP], cwd=ROOT,
                                 stdout=subprocess.PIPE)
        ready, _, _ = select.select([child.stdout], [], [], EVENTS_WAIT_S)
        assert ready, "event plane: the kvstore app server printed no listening line"
        line = child.stdout.readline().decode()
        m = re.search(r"listening on (\d+) \(socket\)", line)
        assert m, f"event plane: the app server printed {line!r}"
        port, app_start_s = int(m.group(1)), time.perf_counter() - t0
        plane = EventPlane(port, tmp, src)
        r = catchup_sync(torch, ops, src, liar=False, n_honest=1, plane=plane)
        info = abci_cli(port, "info")
        query = abci_cli(port, "query", f"tx-{tip}-{CATCHUP_TXS - 1}")
        index = check_index(plane.indexer, blocks, tip)
        launches, marks, sp, ps = r["launches"], r["marks"], r["split"], plane.split
        # the synced chain, as phase 9 checks it
        assert r["caught_at"], "event plane: on_caught_up never fired"
        assert r["bs"].height == tip and r["client"].state.last_block_height == tip
        for h in range(1, tip + 1):
            assert r["bs"].load_block(h).hash() == blocks[h].hash(), ("event plane", h)
        got_app = dict(r["applied"])
        assert sorted(got_app) == list(range(1, tip + 1))
        assert all(got_app[h] == want_app[h] for h in range(1, tip + 1)), "event plane: app hash"
        assert not r["errors"] and all(all(v) for _, v in r["windows"]), r["errors"]
        # 1. blocks and txs on the bus
        assert not plane.cancelled, plane.cancelled
        got = plane.got
        assert [m.data.header.height for m in got["blocks"]] == list(range(1, tip + 1))
        assert [m.data.hash() for m in got["blocks"]] == [blocks[h].hash() for h in range(1, tip + 1)]
        late = [(h, tx) for h in range(EVENTS_TX_AFTER + 1, tip + 1) for tx in blocks[h].data.txs]
        assert [(m.data[0], m.data[2]) for m in got["late_txs"]] == late, len(got["late_txs"])
        assert [m.data[2] for m in got["one_key"]] == [
            tx for tx in blocks[EVENTS_TX_HEIGHT].data.txs if tx.startswith(EVENTS_KEY.encode() + b"=")]
        # 3. the app over the socket, through the CLI
        assert f"last_block_height={tip} " in info, info
        assert info.endswith(f"last_block_app_hash=0x{want_app[tip].hex()}"), info
        assert f"value=b'v{CATCHUP_TXS - 1}'" in query and f"height={tip}" in query, query
        # 4. the kernels
        for name in ("verify_prehashed_bigcache", "neg_pubkey_bigtable", "verify_prehashed_table"):
            assert launches[name] > 0, f"event plane: {name} not launched"
        chk = check_recorded(torch, ed, host, r["rec"], rng, n_vals, "event plane")
        wall = marks["end"] - marks["start"]
        rounds = [d for d in r["rec"].dispatches if d["rows"] > n_vals]
        busy = r["rec"].busy_ms() / 1e3
        print(f"main path: events: a fresh node blocksynced {tip} heights from one honest peer "
              f"over encrypted p2p, its app (kvstore) behind the ABCI socket in a child process "
              f"(up in {app_start_s:.2f} s), its BlockExecutor publishing to an EventBus with an "
              f"IndexerService over a KVIndexer on a SqliteKV; every block hash and app hash equal "
              f"the source's; subscribers received blocks {len(got['blocks'])} (heights 1-{tip} in "
              f"order, hashes the source's), txs past height {EVENTS_TX_AFTER} "
              f"{len(got['late_txs'])}, key {EVENTS_KEY} {len(got['one_key'])}; the indexer "
              f"returned all {index['txs']} txs with height and index, app.creator=kvstore in "
              f"(height, index) order with height {EVENTS_TX_HEIGHT}'s {index['at_height']}, "
              f"block.height={EVENTS_BLOCKS_AFTER + 1}..{tip} each its height; the range form "
              f"(\"tx.height = {EVENTS_TX_HEIGHT}\", \"block.height > {EVENTS_BLOCKS_AFTER}\") "
              f"gave {len(index['range_form'][0])} and {len(index['range_form'][1])}: outside the "
              f"KV indexer's "
              f"type.key=value form; the CLI: {info!r}, {query!r} (the app hash after height "
              f"{tip}, the source's); wall {wall * 1e3:.2f} ms ({tip / wall:.1f} commits/s) beside "
              f"phase 9 (a)'s {wall_a * 1e3:.2f} ms (two honest peers, app in process, no bus) "
              f"in this run; of the wall: {ps['publishes']} publishes {ps['publish'] * 1e3:.2f} ms "
              f"({ps['publish'] / wall:.4f}), the indexer's writes {ps['index'] * 1e3:.2f} ms "
              f"({ps['index'] / wall:.4f}); the socket app's {ps['app_calls']} calls "
              f"{ps['app'] * 1e3:.2f} ms of apply_block's {sp['apply'] * 1e3:.2f} ms "
              f"({ps['app'] / sp['apply']:.4f}); the settle after caught-up "
              f"{ps['settle'] * 1e3:.2f} ms; {len(r['windows'])} window rounds (commits, rows, "
              f"bucket, tier) {[(d['rows'] // n_vals, d['rows'], d['bucket'], d['tier']) for d in rounds]}, "
              f"{len(r['applied'])} LastCommit rounds; every window round equal to its plain "
              f"version at its shape ({chk['windows']}), the {chk['small_rounds']} small-tier "
              f"rounds' {chk['small_rows']} rows through the plain version together, "
              f"{chk['sampled']} seeded rows to the host oracle (tolerance: exact); kernel wrapper "
              f"calls on the card {busy * 1e3:.2f} ms; launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})} | {smi}")
        operated = None
        if operator is not None:
            # the node as it stands, before its teardown: its stores, its
            # bus and indexer, the app server and the process verifier
            operated = operator(SimpleNamespace(
                block_store=r["bs"], state_store=r["state_store"], event_bus=plane.bus,
                indexer=plane.indexer, indexer_service=plane.service, app_port=port,
                chain_id=src.chain_id, tip=tip, want_app=want_app[tip], blocks=blocks))
    finally:
        if child is not None:
            child.kill()
            child.wait(timeout=EVENTS_WAIT_S)
        bv._default = kept
        if plane is not None:
            plane.kv.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, chk["err"], operated


# --- phase 13: the operator plane ----------------------------------------------

OPERATOR_CLIENTS = 64  # RPCProvider light clients that skip 1 -> tip at once
OPERATOR_STRIDE = 8  # the consumer reads every OPERATOR_STRIDE-th height through the proxy
OPERATOR_WAIT_S = 120  # a bound on each wait of the phase
# the port's CUDA kernels as a device trace names them -> the wrappers that
# launch them (one launch a wrapper call)
TRACE_KERNELS = {
    "neg_pubkey_table_kernel": ("neg_pubkey_table",),
    "verify_table_kernel": ("verify_prehashed_table",),
    "verify_generic_kernel": ("verify_prehashed",),
    "dbl_chain_kernel": ("dbl_chain",),
    "neg_pubkey_bigtable_kernel": ("neg_pubkey_bigtable",),
    "verify_bigcache_kernel": ("verify_prehashed_bigcache", "verify_prehashed_bigcache_mxu"),
    "challenge_kernel": ("challenge_batch",),
    "reduce_mod_l_kernel": ("reduce_mod_l",),
    "sha256_kernel": ("sha256_batch",),
    "secp_verify_kernel": ("secp_verify_prehashed",),
}


def loop_shares(stacks) -> dict:
    """Shares of a loop profile's samples (stacks: innermost-first
    "file:line:function" tuples -> samples) by the port directory of each
    sample's innermost port frame: p2p, crypto/aead, chaos, consensus, the
    rest of the port, or none (the loop idle in the selector, or in the
    standard library alone). The sampler keeps file names without their
    directories: a name two directories of the port share counts as the
    rest, but reactor.py, which the mesh's switches run only as the
    consensus reactor; a name of the standard library's top level or of
    the packages an event loop runs (asyncio, concurrent.futures, ...) is
    not read as the port's."""
    import sysconfig

    groups = {"p2p": "p2p", "crypto/aead.py": "crypto/aead", "chaos": "chaos",
              "consensus": "consensus"}
    lib = sysconfig.get_paths()["stdlib"]
    stdlib = {f for d in ("", "asyncio", "concurrent/futures", "collections", "json",
                          "logging", "http", "importlib")
              for f in (os.listdir(os.path.join(lib, d)) if os.path.isdir(os.path.join(lib, d))
                        else ()) if f.endswith(".py")}
    port = os.path.join(ROOT, "tendermint_tpu_torch")
    where: dict = {}
    for dirpath, _, files in os.walk(port):
        rel = os.path.relpath(dirpath, port)
        for f in files:
            if f.endswith(".py"):
                group = groups.get(f"{rel}/{f}", groups.get(rel.split(os.sep)[0], "other port"))
                where.setdefault(f, set()).add(group)
    where = {f: g for f, g in where.items() if f not in stdlib}
    owner = {f: next(iter(g)) if len(g) == 1 else "other port" for f, g in where.items()}
    owner["reactor.py"] = "consensus"
    counts = dict.fromkeys(["p2p", "crypto/aead", "chaos", "consensus", "other port", "none"], 0)
    total = 0
    for stack, n in stacks.items():
        total += n
        for frame in stack:
            name = frame.split(":", 1)[0]
            if name in owner:
                counts[owner[name]] += n
                break
        else:
            counts["none"] += n
    return {"samples": total, "shares": {k: round(v / max(1, total), 4) for k, v in counts.items()}}


def operator_phase(torch, ops, host, smi, rng, handed, step_c: float):
    """Phase 13: an operator profiles a node over its RPC while a light
    proxy serves verified blocks through it. The node is phase 12's, handed
    over before its teardown (`handed`: its block and state stores, its
    EventBus and indexer, its kvstore app's port in the child process, on
    phase 12's process verifier), with what tendermint_tpu/node/node.py
    wires beside them: a LightServePlane over its stores, a HealthMonitor
    bound to the scheduler's metrics and ledger, the serving plane's metrics
    and the tracer, a ProfileCapture (device "cuda") and a started
    VerifyScheduler as the process default, served by the port's RPCServer
    on 127.0.0.1. Over HTTP JSON-RPC: (a) profile_start with the device
    trace (a second start must fail with -32000), a LightProxy's
    LightClient (trusted at height 1, an RPCProvider to the node as primary
    and another as witness) syncs 1 -> tip sequentially through
    default_dispatch("light"), a consumer reads commit, validators, block
    and status through the proxy, OPERATOR_CLIENTS RPCProvider clients skip
    1 -> tip at once, profile_stop; (b) tx_search and tx, abci_query and
    abci_info through the socket app, health, dump_health,
    dump_dispatch_ledger and dump_traces. Checks every header, commit and
    validator set the proxy returns against the source chain, every
    recorded round against its plain version and the host oracle
    (check_recorded), the device trace on with its file and its per-kernel
    launches equal to the phase's counts, the loop profile's samples, the
    ledger route's rounds against the ledger's, tx_search against the
    indexer's search_txs. Prints the proxy's ms a step beside catch-up
    (c)'s in-process `step_c` (seconds) of this run, the clients' wall and
    rounds, the trace's per-kernel split (launch, queue, device), the loop
    profile's top stacks, the health roll-up and the launches. Returns the
    launches, the checks' max_abs_err per kernel and the phase's wall."""
    import shutil
    import tempfile

    from tendermint_tpu_torch import obs
    from tendermint_tpu_torch.abci.client import SocketClient
    from tendermint_tpu_torch.crypto import tmhash
    from tendermint_tpu_torch.crypto.batch_verifier import default_verifier
    from tendermint_tpu_torch.libs.metrics import HealthMetrics, Registry, SchedulerMetrics
    from tendermint_tpu_torch.light.client import LightClient, TrustOptions
    from tendermint_tpu_torch.light.proxy import LightProxy
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.lightserve import LightServePlane
    from tendermint_tpu_torch.ops import ed25519_batch as ed
    from tendermint_tpu_torch.parallel import VerifyScheduler, set_default_scheduler
    from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError
    from tendermint_tpu_torch.rpc.light_provider import RPCProvider
    from tendermint_tpu_torch.rpc.server import RPCServer
    from tendermint_tpu_torch.store.kv import MemKV

    t_phase = time.perf_counter()
    tip, chain_id, bs, ss = handed.tip, handed.chain_id, handed.block_store, handed.state_store
    n_vals = len(ss.load_validators(tip).validators)
    now = CATCHUP_T0 + (tip + 61) * 10**9
    out_dir = tempfile.mkdtemp(prefix="smoke-profiles-")
    tracer = obs.Tracer(enabled=True)
    kept_tracer = obs.default_tracer()
    sched = VerifyScheduler(ledger=obs.DispatchLedger(),
                            metrics=SchedulerMetrics(Registry("smoke_operator")))
    plane = LightServePlane(bs, ss, chain_id)
    monitor = obs.HealthMonitor(tracer=tracer, metrics=HealthMetrics(Registry("smoke_operator")))
    monitor.bind_scheduler(sched.metrics)
    monitor.bind_ledger(sched.ledger)
    monitor.bind_lightserve(plane.cache.metrics)
    monitor.bind_tracer(tracer)
    node = SimpleNamespace(
        node_key=SimpleNamespace(id="smoke-operator"),
        config=SimpleNamespace(base=SimpleNamespace(moniker="smoke-operator"),
                               rpc=SimpleNamespace(unsafe=False)),
        consensus=SimpleNamespace(is_running=False),
        block_store=bs, state_store=ss, event_bus=handed.event_bus, indexer=handed.indexer,
        app=None, lightserve=plane, health_monitor=monitor, verify_scheduler=sched,
        profiler=obs.ProfileCapture(out_dir, device="cuda"), tracer=tracer)
    verifier = default_verifier()
    rec = RoundRecorder(torch, verifier)
    got: dict = {"reads": {}}

    def light_client(primary, witness, sequential):
        return LightClient(chain_id, TrustOptions(CATCHUP_PERIOD_NS, 1, bs.load_block(1).hash()),
                           primary, [witness], LightStore(MemKV()), sequential=sequential,
                           now_ns=lambda: now)

    async def drive():
        node.app = SocketClient(port=handed.app_port)
        await node.app.connect()
        await sched.start()
        await monitor.start()
        server = RPCServer(node, host="127.0.0.1", port=0)
        await server.start()
        addr = f"127.0.0.1:{server.port}"
        http = HTTPClient(addr)
        proxy = pc = None
        clients = []
        try:
            # (a) the profiled proxy sync
            ops.reset_launches()
            got["started"] = await http.call("profile_start", label="operator", device=True)
            try:
                await http.call("profile_start", label="second", device=True)
            except RPCClientError as e:
                got["second"] = e
            lc = light_client(RPCProvider(chain_id, addr), RPCProvider(chain_id, addr), True)
            proxy = LightProxy(lc, addr, listen_host="127.0.0.1", listen_port=0)
            await proxy.start()
            t0 = time.perf_counter()
            lb = await asyncio.wait_for(lc.verify_light_block_at_height(tip), OPERATOR_WAIT_S)
            got["seq_s"] = time.perf_counter() - t0
            got["seq_rounds"] = len(rec.rounds)
            got["proxy_trusted"], got["proxy_hash"] = lc.store.heights(), lb.header.hash()
            pc = HTTPClient(f"127.0.0.1:{proxy.listen_port}")
            t0 = time.perf_counter()
            for h in sorted({*range(1, tip + 1, OPERATOR_STRIDE), tip}):
                got["reads"][h] = (await pc.commit(height=h), await pc.validators(height=h),
                                   await pc.block(height=h))
            got["status"] = await pc.status()
            got["read_s"] = time.perf_counter() - t0
            clients = [light_client(RPCProvider(chain_id, addr), RPCProvider(chain_id, addr), False)
                       for _ in range(OPERATOR_CLIENTS)]
            n0, t0 = len(rec.rounds), time.perf_counter()
            lbs = await asyncio.wait_for(asyncio.gather(
                *(c.verify_light_block_at_height(tip) for c in clients)), OPERATOR_WAIT_S)
            got["swarm_s"], got["swarm_rounds"] = time.perf_counter() - t0, len(rec.rounds) - n0
            got["swarm_rows"] = sum(len(items) for items, _ in rec.rounds[n0:])
            got["swarm_hashes"] = {x.header.hash() for x in lbs}
            got["swarm_trusted"] = [c.store.heights() for c in clients]
            got["stopped"] = await http.call("profile_stop")
            torch.cuda.synchronize()
            got["launches"] = ops.kernel_launches()
            # (b) the node's routes
            query = "app.creator=kvstore"
            got["tx_search"] = await http.call("tx_search", query=query, per_page=1000)
            got["search_txs"] = handed.indexer.search_txs(query, 1000)
            last_tx = handed.blocks[tip].data.txs[-1]
            got["tx"] = await http.call("tx", hash=tmhash.sum(last_tx).hex())
            key = f"tx-{tip}-{CATCHUP_TXS - 1}".encode()
            got["abci_query"] = await http.call("abci_query", path="", data=key.hex())
            got["abci_info"] = await http.call("abci_info")
            got["health"] = await http.call("health")
            got["dump_health"] = await http.call("dump_health")
            got["ledger_route"] = await http.call("dump_dispatch_ledger", entries=0)
            got["ledger"] = sched.ledger.summary()
            got["dump_traces"] = await http.call("dump_traces", heights=4)
        finally:
            for c in clients:
                for prov in [c.primary, *c.witnesses]:
                    await prov.client.close()
            if pc is not None:
                await pc.close()
            if proxy is not None:
                await asyncio.wait_for(proxy.stop(), OPERATOR_WAIT_S)
            await http.close()
            await asyncio.wait_for(server.stop(), OPERATOR_WAIT_S)
            await monitor.stop()
            await sched.stop()
            await node.app.close()

    gc.collect()
    obs.set_default_tracer(tracer)
    set_default_scheduler(sched)
    rec.install()
    try:
        run_bounded(drive())
    finally:
        rec.remove()
        set_default_scheduler(None)
        obs.set_default_tracer(kept_tracer)
    try:
        launches, stopped = got["launches"], got["stopped"]
        # the proxy's sync and what it served
        blocks = handed.blocks
        assert got["proxy_trusted"] == list(range(1, tip + 1)), got["proxy_trusted"][:5]
        assert got["proxy_hash"] == blocks[tip].hash()
        for h, (commit, vals, blk) in got["reads"].items():
            hdr, c = blocks[h].header, blocks[h + 1].last_commit
            sh = commit["signed_header"]
            assert sh["header"] == {
                "chain_id": chain_id, "height": h, "time": hdr.time_ns,
                "app_hash": hdr.app_hash.hex().upper(),
                "validators_hash": hdr.validators_hash.hex().upper(),
                "next_validators_hash": hdr.next_validators_hash.hex().upper()}, h
            assert sh["commit"] == {"height": c.height, "round": c.round,
                                    "block_id": {"hash": hdr.hash().hex().upper()}}, h
            want_vals = ss.load_validators(h).validators
            assert vals["count"] == vals["total"] == len(want_vals), h
            assert [(v["address"], v["pub_key"], v["voting_power"]) for v in vals["validators"]] == [
                (v.address.hex().upper(), v.pub_key.data.hex(), v.voting_power)
                for v in want_vals], h
            assert blk["block_id"]["hash"] == blk["block"]["header"]["hash"] == \
                hdr.hash().hex().upper(), h
            assert blk["block"]["data"]["txs"] == [tx.hex().upper() for tx in blocks[h].data.txs]
        st = got["status"]["sync_info"]
        assert (st["latest_block_height"], st["latest_block_hash"]) == (
            tip, blocks[tip].hash().hex().upper()), st
        assert got["swarm_hashes"] == {blocks[tip].hash()}
        assert all(t[-1] == tip for t in got["swarm_trusted"])
        # the profile session and the device trace
        assert got["started"]["started"] is True
        dt0 = got["started"]["device_trace"]
        assert dt0["enabled"] is True and dt0["activities"] == ["CPU", "CUDA"], dt0
        second = got.get("second")
        assert second is not None and second.code == -32000, "a second profile_start ran"
        dt = stopped["device_trace"]
        assert dt["enabled"] is True and "stop_error" not in dt, dt
        assert os.path.isfile(dt["path"]), dt["path"]
        trace_mb = os.path.getsize(dt["path"]) / 2**20
        by_wrapper: dict = {}
        port_rows = [k for k in dt["kernels"] if k["name"] in TRACE_KERNELS]
        for k in port_rows:
            for w in TRACE_KERNELS[k["name"]]:
                if launches.get(w):
                    by_wrapper[w] = by_wrapper.get(w, 0) + k["launches"]
                    break
            else:
                raise AssertionError(f"operator plane: {k['name']} in the trace, not launched")
        assert by_wrapper == {w: n for w, n in launches.items() if n}, (
            "operator plane: the trace's launches differ from the counts", by_wrapper,
            {w: n for w, n in launches.items() if n}, [k["name"][:80] for k in dt["kernels"]])
        assert launches["verify_prehashed_table"] > 0, "operator plane: kernel 3 not launched"
        lp = stopped["loop_profile"]
        assert lp["samples"] > 0 and os.path.isfile(lp["path"]), lp
        # the rounds against the plain versions and the host oracle
        chk = check_recorded(torch, ed, host, rec, rng, n_vals, "operator plane")
        # the routes
        want_search = [(x.height, x.index, x.tx.hex().upper()) for x in got["search_txs"]]
        assert [(t["height"], t["index"], t["tx"]) for t in got["tx_search"]["txs"]] == want_search
        assert got["tx_search"]["total_count"] == len(want_search) == tip * CATCHUP_TXS
        tx = got["tx"]
        assert (tx["height"], tx["index"], tx["tx"]) == (
            tip, CATCHUP_TXS - 1, blocks[tip].data.txs[-1].hex().upper()), tx
        assert got["abci_query"]["response"]["value"] == \
            f"v{CATCHUP_TXS - 1}".encode().hex().upper(), got["abci_query"]
        info = got["abci_info"]["response"]
        assert info["last_block_height"] == tip, info
        assert info["last_block_app_hash"] == handed.want_app.hex().upper(), info
        health = got["health"]
        assert health["monitored"] is True and health["latest_block_height"] == tip, health
        assert health["status"] in ("ok", "warn", "critical"), health
        dh = got["dump_health"]
        assert dh["enabled"] is True and {"scheduler", "lightserve"} <= set(dh["subsystems"])
        led = got["ledger_route"]
        assert led["enabled"] is True and led["entries"] == []
        assert led["summary"]["rounds"] == got["ledger"]["rounds"] == len(rec.rounds), (
            led["summary"]["rounds"], got["ledger"]["rounds"], len(rec.rounds))
        traces = got["dump_traces"]
        assert traces["enabled"] is True and traces["records"], "dump_traces: an empty ring"
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    steps = tip - 1
    split = "; ".join(
        f"{k['name']} {k['launches']} launches: launch (cudaLaunchKernel) median "
        f"{k['launch_ms']['median']:.4f} ms total {k['launch_ms']['total']:.2f}, queue median "
        f"{k['queue_ms']['median']:.4f} ms, device median {k['device_ms']['median']:.4f} ms "
        f"total {k['device_ms']['total']:.2f}" for k in port_rows)
    other = [(k["name"][:60], k["launches"], k["device_ms"]["total"])
             for k in dt["kernels"] if k["name"] not in TRACE_KERNELS]
    top = [(s["count"], " < ".join(s["stack"][:3])) for s in lp["top_stacks"][:3]]
    subs = {k: v["status"] for k, v in dh["subsystems"].items()}
    print(f"main path: operator plane: phase 12's node served by the port's RPCServer "
          f"(LightServePlane, HealthMonitor, ProfileCapture on cuda, VerifyScheduler, its kvstore "
          f"app over the ABCI socket); profile_start armed the device trace "
          f"(activities {dt0['activities']}), a second start refused ({second.code}); a "
          f"LightProxy's LightClient synced 1 -> {tip} sequentially over RPC "
          f"({got['seq_rounds']} rounds of {n_vals} rows), the consumer read commit, "
          f"validators, block at {len(got['reads'])} heights and status through the proxy, each "
          f"equal to the source chain's; {OPERATOR_CLIENTS} RPCProvider clients skipped 1 -> "
          f"{tip} at once in {got['swarm_rounds']} rounds of {got['swarm_rows']} rows, every one "
          f"at the source's header; profile_stop: the trace {trace_mb:.1f} MiB, per-kernel "
          f"launches equal to the phase's counts {json.dumps(by_wrapper)} ("
          f"{dt['launch_calls']} launch calls, {dt['unpaired']} kernels without one), the "
          f"loop profile {lp['samples']} samples; routes: tx_search "
          f"{got['tx_search']['total_count']} txs equal to search_txs, tx, abci_query "
          f"{bytes.fromhex(got['abci_query']['response']['value'])!r}, abci_info height "
          f"{info['last_block_height']}, health {health['status']}, dump_health {subs}, "
          f"dump_dispatch_ledger {led['summary']['rounds']} rounds (the ledger's), dump_traces "
          f"{len(traces['records'])} records; every round equal to its plain version "
          f"({chk['windows']} at their shape, {chk['small_rounds']} small-tier rounds' "
          f"{chk['small_rows']} rows together), {chk['sampled']} seeded rows to the host oracle "
          f"(tolerance: exact); launches {json.dumps({k: v for k, v in launches.items() if v})} "
          f"| {smi}")
    print(f"time: operator plane: the proxy's sync over RPC {got['seq_s'] * 1e3 / steps:.2f} ms a "
          f"step ({steps} steps, {got['seq_s'] * 1e3:.2f} ms) beside catch-up (c)'s in-process "
          f"{step_c * 1e3:.2f} ms a step in this run; the consumer's {4 * len(got['reads'])} "
          f"reads through the proxy {got['read_s'] * 1e3:.2f} ms; {OPERATOR_CLIENTS} skipping "
          f"clients {got['swarm_s'] * 1e3:.2f} ms; phase {wall:.1f} s | {smi}")
    print(f"trace: operator plane, per kernel from torch.profiler's CUDA trace (paired by "
          f"correlation id; queue = kernel start less its launch call's start): {split}; other "
          f"kernels (PyTorch's own) {other}; other device activity {json.dumps(dt['other_gpu'])}; "
          f"the loop profile's top stacks (samples, innermost frames) {top}; health roll-up "
          f"{dh['status']} {subs}, incidents {len(dh['incidents'])} | {smi}")
    return launches, chk["err"], wall


# --- phase 14: the assembled node, started by the CLI --------------------------

NODE_WAIT_S = 120  # a bound on each wait of the phase
NODE_STOP_S = 30  # a child stopped by SIGINT exits 0 inside this
TESTNET_VALIDATORS = 4
TESTNET_HEIGHT = 3  # every validator of the CLI testnet commits this height
# the tiers the node's prewarm covers, checked by the prewarm tool's --verify
# (the sequencer class rides the fn lane and records no tier)
NODE_FAMILIES = "consensus,evidence,blocksync,light,lightserve"


def free_ports(k: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(k)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def spawn_cli(args, log_path: str, device: str, env=None) -> subprocess.Popen:
    """`python -m tendermint_tpu_torch --device <device> <args>` from the
    checkout's root, its output in log_path."""
    with open(log_path, "wb") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "tendermint_tpu_torch", "--device", device, *args],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, env=env)


async def wait_exit(proc: subprocess.Popen, limit: float) -> int | None:
    """The child's exit code once it exited, None past `limit` seconds;
    polls without blocking the event loop."""
    deadline = time.perf_counter() + limit
    while proc.poll() is None and time.perf_counter() < deadline:
        await asyncio.sleep(0.05)
    return proc.poll()


async def sigint_all(procs, limit: float = NODE_STOP_S) -> list:
    """SIGINT every child still running, then their exit codes (None for
    one that outlived `limit` seconds; it is killed)."""
    import signal

    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGINT)
    rcs = [await wait_exit(p, limit) for p in procs]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return rcs


async def rpc_call(port: int, method: str, **params):
    """One JSON-RPC call to the node on `port`, on a connection of its own."""
    from tendermint_tpu_torch.rpc.client import HTTPClient

    client = HTTPClient(f"127.0.0.1:{port}")
    try:
        return await asyncio.wait_for(client.call(method, **params), 30)
    finally:
        await client.close()


async def rpc_until(port: int, cond, what: str, proc, limit: float = NODE_WAIT_S):
    """Poll the node's `status` over its RPC until cond(status); fails past
    `limit` or when the child `proc` exited."""
    from tendermint_tpu_torch.rpc.client import RPCClientError

    deadline = time.perf_counter() + limit
    while True:
        assert proc.poll() is None, f"{what}: the node exited rc={proc.poll()}"
        try:
            status = await rpc_call(port, "status")
            if cond(status):
                return status
        except (OSError, asyncio.TimeoutError, RPCClientError):
            pass  # not up yet
        assert time.perf_counter() < deadline, f"node: no {what} in {limit} s"
        await asyncio.sleep(0.05)


async def http_get(port: int, path: str) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), NODE_WAIT_S)
    finally:
        writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    assert b" 200 " in head.split(b"\r\n")[0], (path, head[:200])
    return body


def sink_reactor():
    """A reactor that takes the messages a full node sends on the channels
    other than blocksync's (consensus, evidence, statesync, sequencer) and
    drops them: beside a BlocksyncReactor it makes a peer that serves
    blocks and nothing else, where mconn would close a connection on a
    channel it does not know."""
    from tendermint_tpu_torch.consensus import reactor as cr
    from tendermint_tpu_torch.evidence.reactor import EVIDENCE_CHANNEL
    from tendermint_tpu_torch.p2p.mconn import ChannelDescriptor
    from tendermint_tpu_torch.p2p.switch import Reactor
    from tendermint_tpu_torch.sequencer import broadcast_reactor as sr
    from tendermint_tpu_torch.statesync.reactor import CHUNK_CHANNEL, SNAPSHOT_CHANNEL

    class Sink(Reactor):
        def get_channels(self):
            return [ChannelDescriptor(id=c) for c in (
                cr.STATE_CHANNEL, cr.DATA_CHANNEL, cr.VOTE_CHANNEL, cr.VOTE_SET_BITS_CHANNEL,
                cr.VOTE_BATCH_CHANNEL, EVIDENCE_CHANNEL, SNAPSHOT_CHANNEL, CHUNK_CHANNEL,
                sr.BLOCK_BROADCAST_CHANNEL, sr.SEQUENCER_SYNC_CHANNEL)]

        async def receive(self, channel_id, peer, msg) -> None:
            pass

    return Sink("sink")


def node_config(home: str, genesis, **fields):
    """A node home: the port's Config with `fields` ("section.knob": value)
    saved to config/config.toml, and `genesis` as its genesis file."""
    from tendermint_tpu_torch.config import Config

    cfg = Config()
    cfg.root_dir = home
    for key, value in fields.items():
        section, knob = key.split(".")
        setattr(getattr(cfg, section), knob, value)
    cfg.ensure_dirs()
    genesis.save_as(cfg.genesis_file)
    cfg.save()
    return cfg


def node_phase(smi, src, wall_a: float, device: str = "cuda"):
    """Phase 14 (a): a fresh full node started by the CLI catches up.
    Phase 9's chain, src, is served by two BlocksyncReactor peers over
    encrypted p2p on this process's event loop (catchup_store, as
    catchup_sync serves it); a home holds its genesis, [scheduler] prewarm =
    true, the RPC and the debug server on free ports and the peers as
    persistent peers; `python -X importtime -m tendermint_tpu_torch --home H
    start --device cuda` runs as a child. The child loads the kernels from
    the build cache (its log's `cuda kernels` line), warms the 150 keys,
    prewarms the ladder (its manifest), blocksyncs to the tip and switches
    to consensus. Polled over its RPC without blocking the loop: every
    height's block hash, commit and app hash against src's; its rounds from
    dump_dispatch_ledger; its launches per kernel from the debug server's
    /debug/torch/launches; then the prewarm tool's --verify against its
    manifest, and SIGINT: exit 0 inside NODE_STOP_S. Returns the child's
    launches."""
    import shutil
    import tempfile

    from tendermint_tpu_torch.blocksync.reactor import BlocksyncReactor

    tip = src.heights - 1
    n_vals = len(src.state.validators.validators)
    blocks = {h: src.bs.load_block(h) for h in range(1, tip + 2)}
    tmp = tempfile.mkdtemp(prefix="smoke-node-")
    home = os.path.join(tmp, "home")
    log = os.path.join(tmp, "node.log")
    servers = []
    for i in range(2):
        state, executor, bs, l2 = catchup_node(src, catchup_store(src))
        servers.append(p2p_node(b"node-server%d" % i, src.chain_id, "blocksync",
                                BlocksyncReactor(state, executor, bs, l2, active=False)))
        servers[-1][2].add_reactor("sink", sink_reactor())
    out = {}

    async def drive():
        for _, t, sw in servers:
            await t.listen()
            await sw.start()
        child = None
        try:
            rpc, p2p, pprof = free_ports(3)
            cfg = node_config(
                home, src.genesis, **{
                    "base.db_backend": "memory",
                    "rpc.laddr": f"tcp://127.0.0.1:{rpc}",
                    "rpc.pprof_laddr": f"tcp://127.0.0.1:{pprof}",
                    "p2p.laddr": f"tcp://127.0.0.1:{p2p}",
                    "p2p.pex": False,
                    "p2p.persistent_peers": ",".join(
                        f"{nk.id}@127.0.0.1:{t.listen_port}" for nk, t, _ in servers),
                    "scheduler.prewarm": True,
                })
            env = {k: v for k, v in os.environ.items() if k != "TM_TPU_SKIP_WARM"}
            t0 = time.perf_counter()
            with open(log, "wb") as f:
                child = subprocess.Popen(
                    [sys.executable, "-X", "importtime", "-m", "tendermint_tpu_torch",
                     "--home", home, "start", "--device", device],
                    cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, env=env)
            await rpc_until(rpc, lambda s: True, "RPC", child)
            out["rpc_up_s"] = time.perf_counter() - t0
            st = await rpc_until(
                rpc, lambda s: int(s["sync_info"]["latest_block_height"]) >= tip,
                f"height {tip}", child)
            out["tip_s"] = time.perf_counter() - t0
            out["sync_s"] = out["tip_s"] - out["rpc_up_s"]
            manifest = cfg.path(cfg.scheduler.prewarm_manifest)
            deadline = time.perf_counter() + NODE_WAIT_S
            while not os.path.exists(manifest):
                assert child.poll() is None, f"node: exited rc={child.poll()} before its prewarm"
                assert time.perf_counter() < deadline, "node: no prewarm manifest"
                await asyncio.sleep(0.05)
            out["warm_s"] = time.perf_counter() - t0
            await asyncio.sleep(0.2)  # the manifest's writer closes the file
            # the chain: every block hash, commit and app hash equal src's
            for h in range(1, tip + 1):
                got_b = await rpc_call(rpc, "block", height=h)
                got_c = await rpc_call(rpc, "commit", height=h)
                want_c = blocks[h + 1].last_commit
                assert got_b["block_id"]["hash"] == blocks[h].hash().hex().upper(), ("node", h)
                assert got_b["block"]["header"]["app_hash"] == (
                    blocks[h].header.app_hash.hex().upper()), ("node app hash", h)
                c = got_c["signed_header"]["commit"]
                assert c["block_id"]["hash"] == want_c.block_id.hash.hex().upper(), ("commit", h)
                assert [s["signature"] for s in c["signatures"]] == [
                    s.signature.hex().upper() for s in want_c.signatures], ("commit sigs", h)
            # the app after the tip: block tip + 1's app hash
            info = (await rpc_call(rpc, "abci_info"))["response"]
            assert int(info["last_block_height"]) == tip, info
            assert info["last_block_app_hash"] == (
                blocks[tip + 1].header.app_hash.hex().upper()), "node: app hash after the tip"
            st = await rpc_call(rpc, "status")
            out["catching_up"] = st["sync_info"]["catching_up"]
            assert out["catching_up"] is False, "node: still catching up at the tip"
            out["ledger"] = await rpc_call(rpc, "dump_dispatch_ledger", entries=4096)
            out["debug"] = json.loads(await http_get(pprof, "/debug/torch/launches"))
            with open(manifest) as f:
                out["manifest"] = json.load(f)
            # the prewarm tool re-runs the node's manifest on the card
            t1 = time.perf_counter()
            verify = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "tendermint_tpu_torch.tools.prewarm", "--verify",
                "--out", manifest, "--device", device, "--families", NODE_FAMILIES,
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            text, _ = await asyncio.wait_for(verify.communicate(), NODE_WAIT_S)
            out["prewarm_verify"] = (verify.returncode, text.decode(errors="replace"),
                                     time.perf_counter() - t1)
            t1 = time.perf_counter()
            (rc,) = await sigint_all([child])
            out["stop"] = (rc, time.perf_counter() - t1)
        finally:
            if child is not None and child.poll() is None:
                child.kill()
                child.wait()
            for _, t, sw in servers:
                await sw.stop()

    try:
        try:
            asyncio.run(drive())
        finally:
            with open(log, errors="replace") as f:
                text = f.read()
    except BaseException:
        print("node: its log's tail\n" + "\n".join(
            line for line in text.splitlines() if not line.startswith("import time:"))[-4000:],
            file=sys.stderr)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rc, verify_text, verify_s = out["prewarm_verify"]
    assert rc == 0 and "verify OK" in verify_text, f"node: prewarm --verify rc={rc}\n{verify_text[-3000:]}"
    stop_rc, stop_s = out["stop"]
    assert stop_rc == 0, f"node: SIGINT exit code {stop_rc}\n{text[-3000:]}"
    built = re.search(r"cuda kernels (.*)", text) if device == "cuda" else None
    assert device != "cuda" or built, "node: no `cuda kernels` line in its log"
    build = out["debug"]["build"]
    assert device != "cuda" or build.get("reused") is True, f"node: built its kernels {build}"
    torch_us = [int(m.group(1)) for m in re.finditer(
        r"import time:\s+\d+ \|\s+(\d+) \|\s+torch$", text, re.M)]
    launches = out["debug"]["launches"]
    names = {"small": "verify_prehashed_table", "big": "verify_prehashed_bigcache",
             "generic": "verify_prehashed"}
    entries = [e for e in out["ledger"]["entries"] if e["engine"] == "sig"]
    rounds = [(("big" if e["dispatched"] >= 512 else "small"), e["requested"], e["dispatched"])
              for e in entries]
    windows = [r for r in rounds if r[1] > n_vals]
    if device == "cuda":
        for name in ("verify_prehashed_table", "neg_pubkey_bigtable", "verify_prehashed_bigcache"):
            assert launches.get(name, 0) > 0, f"node: {name} not launched"
    prewarm = out["manifest"]["entries"]
    print(f"main path: node: `python -m tendermint_tpu_torch --home H start --device {device}` "
          f"as a child with phase 9's genesis ({n_vals} validators), [scheduler] prewarm on, "
          f"two BlocksyncReactor peers serving phase 9's chain over encrypted p2p; the build "
          f"{json.dumps(build)} (the log's line: {built.group(1) if built else 'none'}); it "
          f"blocksynced {tip} heights and switched to consensus (catching_up "
          f"{out['catching_up']}); every block hash, commit (signatures) and app hash at heights "
          f"1-{tip} equal phase 9's; {len(rounds)} signature rounds in its ledger, {len(windows)} "
          f"windows (tier, rows, bucket) {windows}, {len(rounds) - len(windows)} of at most "
          f"{n_vals} rows (LastCommits; (tier, rows, bucket): count "
          f"{sorted(collections.Counter(r for r in rounds if r[1] <= n_vals).items())}); its "
          f"prewarm manifest {len(prewarm)} launches ({sorted({e['tier'] for e in prewarm})}, "
          f"{sum(e['seconds'] for e in prewarm):.2f} s), the prewarm tool's --verify on it OK "
          f"in {verify_s:.1f} s; SIGINT: exit 0 in {stop_s:.2f} s; its launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} | {smi}")
    print(f"time: node: boot (spawn to its RPC answering) {out['rpc_up_s']:.2f} s, of it "
          f"torch's import {torch_us[0] / 1e6 if torch_us else float('nan'):.2f} s and the "
          f"kernels' load {build.get('seconds', 0.0):.2f} s; the table warm and the prewarm "
          f"done {out['warm_s']:.2f} s after spawn; the sync, RPC up to height {tip}, "
          f"{out['sync_s'] * 1e3:.2f} ms ({tip / out['sync_s']:.1f} commits/s) beside phase 9 "
          f"(a)'s {wall_a * 1e3:.2f} ms in this run (an in-process node, polled at 50 ms) | {smi}")
    return launches


def testnet_phase(smi, device: str = "cuda"):
    """Phase 14 (b): the CLI testnet behind one verify service. `testnet
    --v 4` writes the homes (the CLI's own function), ports rewritten to
    free ones and every [scheduler] remote_socket pointed at one
    `verify-service --device cuda` child (its stats port for the ledger);
    four `start --device cuda` children share the card. All reach
    TESTNET_HEIGHT with equal block hashes at height 2, no child built the
    kernels (each log's `cuda kernels` line: reused), then SIGINT: every
    child exits 0."""
    import shutil
    import tempfile

    from tendermint_tpu_torch.__main__ import main as cli_main
    from tendermint_tpu_torch.config import Config
    from tendermint_tpu_torch.p2p.key import NodeKey

    n = TESTNET_VALIDATORS
    tmp = tempfile.mkdtemp(prefix="smk")
    base = os.path.join(tmp, "net")
    sock = os.path.join(tmp, "vs.sock")
    out = {}

    async def drive():
        procs = []
        try:
            t0 = time.perf_counter()
            assert cli_main(["testnet", "--v", str(n), "--output", base,
                             "--chain-id", "smoke-testnet"]) == 0
            homes = [os.path.join(base, f"node{i}") for i in range(n)]
            ports = free_ports(2 * n + 1)
            p2p, rpc, stats = ports[:n], ports[n:2 * n], ports[-1]
            ids = [NodeKey.load_or_generate(os.path.join(h, "config", "node_key.json")).id
                   for h in homes]
            for i, h in enumerate(homes):
                cfg = Config.load(h)
                cfg.root_dir = h
                cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p[i]}"
                cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc[i]}"
                cfg.p2p.persistent_peers = ",".join(
                    f"{ids[j]}@127.0.0.1:{p2p[j]}" for j in range(n) if j != i)
                cfg.scheduler.remote_socket = sock
                cfg.save()
            svc = spawn_cli(["verify-service", "--socket", sock, "--stats-port", str(stats)],
                            os.path.join(tmp, "service.log"), device)
            procs.append(svc)
            deadline = time.perf_counter() + NODE_WAIT_S
            while not os.path.exists(sock):
                assert svc.poll() is None, f"testnet: the service exited rc={svc.poll()}"
                assert time.perf_counter() < deadline, "testnet: the service never bound"
                await asyncio.sleep(0.05)
            out["service_s"] = time.perf_counter() - t0
            env = {k: v for k, v in os.environ.items() if k != "TM_TPU_SKIP_WARM"}
            for i, h in enumerate(homes):
                procs.append(spawn_cli(["--home", h, "start"],
                                       os.path.join(tmp, f"node{i}.log"), device, env=env))
            for i in range(n):
                await rpc_until(rpc[i], lambda s: int(
                    s["sync_info"]["latest_block_height"]) >= TESTNET_HEIGHT,
                    f"testnet node{i} height {TESTNET_HEIGHT}", procs[1 + i])
            out["height_s"] = time.perf_counter() - t0
            hashes = set()
            for i in range(n):
                blk = await rpc_call(rpc[i], "block", height=2)
                hashes.add(blk["block_id"]["hash"])
            out["hashes"] = hashes
            out["ledger"] = json.loads(await http_get(stats, "/dump_dispatch_ledger"))
            t1 = time.perf_counter()
            out["rcs"] = await sigint_all(procs)
            out["stop_s"] = time.perf_counter() - t1
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()

    logs = {}
    try:
        try:
            asyncio.run(drive())
        finally:
            for name in ["service"] + [f"node{i}" for i in range(n)]:
                path = os.path.join(tmp, f"{name}.log")
                if os.path.exists(path):
                    with open(path, errors="replace") as f:
                        logs[name] = f.read()
    except BaseException:
        for name, text in logs.items():
            print(f"testnet: {name}'s log's tail\n{text[-2000:]}", file=sys.stderr)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert len(out["hashes"]) == 1, f"testnet: height 2 differs {out['hashes']}"
    assert out["rcs"] == [0] * (n + 1), (out["rcs"], {k: v[-1500:] for k, v in logs.items()})
    builds = {}
    for i in range(n):
        m = re.search(r"cuda kernels (.*)", logs[f"node{i}"])
        assert device != "cuda" or (m and "reused=True" in m.group(1)), (
            f"testnet: node{i} did not load a finished build: {m and m.group(1)}")
        builds[f"node{i}"] = m.group(1) if m else None
    led = out["ledger"]
    entries = led.get("entries", [])
    sig = [e for e in entries if e["engine"] == "sig"]
    under = sum(e["requested"] < 8 for e in sig)
    summary = led.get("summary", {})
    print(f"main path: testnet: `testnet --v {n}` (ports rewritten), one `verify-service "
          f"--device {device}` child and {n} `start --device {device}` children on one card, "
          f"every [scheduler] remote_socket the service's; all reached height {TESTNET_HEIGHT}, "
          f"height 2's block hash equal on all ({out['hashes'].pop()[:16]}...); no node built the "
          f"kernels: {json.dumps(builds)}; the service's ledger, merged across "
          f"{len(led.get('per_client', {}))} tenants: {summary.get('rounds')} rounds, "
          f"{summary.get('rows_requested')} rows requested, {len(sig)} signature rounds in its "
          f"entries (rows {[e['requested'] for e in sig][:40]}), {under} of them under "
          f"min_device_batch (8) to the host oracle; SIGINT: all {n + 1} exited 0 in "
          f"{out['stop_s']:.2f} s | {smi}")
    print(f"time: testnet: the service bound {out['service_s']:.2f} s after start, every node at "
          f"height {TESTNET_HEIGHT} {out['height_s']:.2f} s after start | {smi}")


# --- the harnesses: the port's tools/ at their own sizes ---------------------

# committee sizes of the verify-service family and of the QC catch-up: the
# tools' own defaults (run_family, run_qc_catchup), not cut
HARNESS_SIZES = (4, 32, 100)
HARNESS_HEIGHTS = 2  # measured heights a size of the verify-service family
HARNESS_WARM = 2  # warm heights before them
HARNESS_PROCS = 8  # worker processes at most a size
# the service's round cap: the knee the reference harness names for a card
# (its default, 2,048, stays the tool's)
HARNESS_MAX_BATCH = 16384
HARNESS_POLL_S = 1.0  # nvidia-smi and /proc polls while the family runs
SOAK_SEED = 0  # the soak iteration's scenario seed
SOAK_TIMEOUT_S = 240


def compute_apps() -> list[tuple]:
    """(pid, used memory) of each compute app nvidia-smi lists: a row for
    each CUDA context on the card. In a PID namespace of its own the PIDs
    are not this namespace's."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    ).stdout
    rows = [[f.strip() for f in ln.split(",")] for ln in out.splitlines() if ln.strip()]
    return [(int(r[0]), r[1]) for r in rows if len(r) == 2 and r[0].isdigit()]


def opens_card(pid: int) -> bool:
    """Whether process `pid` holds a /dev/nvidia* file open, as a process
    with a CUDA context does."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


class CardHolders(threading.Thread):
    """While the verify-service family runs: every HARNESS_POLL_S, the
    compute apps nvidia-smi lists, and the bench's children alive (found by
    the socket path run_size gives them, vsbench-<this pid>-<n>.sock: the
    service child, `verify-service`, and the `--worker` processes), each
    with whether it holds the card's device files. polls[n] for size n."""

    def __init__(self):
        super().__init__(daemon=True)
        self.polls: dict[int, list] = collections.defaultdict(list)
        self.done = threading.Event()
        self._sock = re.compile(rb"vsbench-%d-(\d+)\.sock" % os.getpid())

    def children(self) -> dict:
        found = {}
        for d in os.listdir("/proc"):
            if not d.isdigit():
                continue
            try:
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    args = f.read().split(b"\0")
            except OSError:
                continue
            m = next((self._sock.search(a) for a in args if self._sock.search(a)), None)
            role = "worker" if b"--worker" in args else "service" if b"verify-service" in args else None
            if m and role:
                found.setdefault(int(m.group(1)), []).append((role, int(d)))
        return found

    def run(self):
        while not self.done.wait(HARNESS_POLL_S):
            kids = self.children()
            if not kids:
                continue
            apps = compute_apps()
            for n, procs in kids.items():
                self.polls[n].append({
                    "apps": apps,
                    "service": [p for r, p in procs if r == "service"],
                    "workers": [p for r, p in procs if r == "worker"],
                    "holding": [p for _, p in procs if opens_card(p)],
                })


def check_holders(n: int, polls: list) -> str:
    """A size's holders: the service child held the card and no worker ever
    did (by their device files), and nvidia-smi listed two contexts at most
    and two at some poll, the smoke's and the service's: no worker's. It
    counts rows, since in a PID namespace of its own nvidia-smi's PIDs are
    not this namespace's. Returns the line's account."""
    services = {p for q in polls for p in q["service"]}
    workers = {p for q in polls for p in q["workers"]}
    holding = {p for q in polls for p in q["holding"]}
    counts = [len(q["apps"]) for q in polls]
    assert services and workers, f"harnesses (a) n={n}: the bench's children were not seen"
    assert not workers & holding, f"harnesses (a) n={n}: a worker holds the card {workers & holding}"
    assert services & holding, f"harnesses (a) n={n}: the service child never held the card"
    assert max(counts) == 2, (
        f"harnesses (a) n={n}: nvidia-smi listed {sorted(set(counts))} contexts a poll, not the "
        f"smoke's and the service's: {polls[counts.index(max(counts))]['apps']}")
    both = polls[counts.index(2)]["apps"]
    return (f"{len(polls)} polls: nvidia-smi listed 2 contexts at most, the smoke's and the "
            f"service's, in {counts.count(2)} ({both}), never a worker's; {len(workers)} workers "
            f"seen, none with /dev/nvidia* open, the service with them")


def service_family(smi) -> list:
    """Phase 15 (a): verify_service_bench.run_family at HARNESS_SIZES, one
    `python -m tendermint_tpu_torch verify-service --device cuda` child a
    size and up to HARNESS_PROCS worker processes submitting n ed25519 vote
    rows and one n-signer BLS group a node and height, watched by
    CardHolders. Every size: no error, real signatures, zero degrades, the
    holders' checks. The service's launches are in its own process, which
    serves no launch counts: its ledger's rounds stand for them."""
    from tendermint_tpu_torch.crypto.batch_verifier import BIGTABLE_MIN
    from tendermint_tpu_torch.tools import verify_service_bench as vsb

    watch = CardHolders()
    watch.start()
    t0 = time.perf_counter()
    try:
        fam = vsb.run_family(sizes=HARNESS_SIZES, heights=HARNESS_HEIGHTS, warm=HARNESS_WARM,
                             max_procs=HARNESS_PROCS, service_max_batch=HARNESS_MAX_BATCH,
                             device="cuda")
    finally:
        watch.done.set()
        watch.join()
    wall = time.perf_counter() - t0
    rows = fam["sizes"]
    assert [r["n"] for r in rows] == list(HARNESS_SIZES), rows
    for r in rows:
        assert "error" not in r, f"harnesses (a) n={r['n']}: {r.get('error')}"
        assert r["sig_verify"] == "real" and r["degrades"] == 0, r
        holders = check_holders(r["n"], watch.polls[r["n"]])
        led = r["service_ledger"]
        tiers = {"small": {}, "big": {}}
        for b, v in led["by_bucket"].items():
            tiers["big" if int(b) >= BIGTABLE_MIN else "small"][b] = v["rounds"]
        engines = {k: v["rounds"] for k, v in led["per_engine"].items()}
        print(f"main path: harnesses (a) verify-service n={r['n']}: {r['processes']} worker "
              f"processes, {HARNESS_WARM} warm + {HARNESS_HEIGHTS} measured heights of {r['n']} "
              f"ed25519 rows and one {r['n']}-signer BLS group a node; wall "
              f"{r['wall_ms_per_height']} ms a height, requests per dispatch "
              f"{r['requests_per_dispatch']} (all rounds {r['requests_per_dispatch_all_rounds']}), "
              f"IPC round trip {r['ipc_rtt_mean_ms']} ms (overhead {r['ipc_overhead_ms']} ms), "
              f"remote submissions {r['remote_submissions']}, degrades {r['degrades']}, "
              f"sig_verify {r['sig_verify']}, tenants {r['per_client_tenants']}, spawn to done "
              f"{r['spawn_to_done_s']} s; the service's ledger: {led['rounds']} rounds "
              f"{json.dumps(engines)}, {led['rows_requested']} rows, signature rounds by tier and "
              f"bucket {json.dumps(tiers)} (those under min_device_batch on its host oracle; "
              f"its launches are in the child, not counted), device "
              f"{led['device_seconds'] * 1e3:.2f} ms, prep {led['host_prep_seconds'] * 1e3:.2f} "
              f"ms; {holders} | {smi}")
    print(f"time: harnesses (a): the family {wall:.1f} s, headline {fam['metric']} "
          f"{fam['value']} ms | {smi}")
    return wall


def qc_catchup(torch, ops, smi) -> tuple:
    """Phase 15 (b): qc_bench.run_qc_catchup at its defaults (committees of
    4, 32 and 100, 8 blocks of genuine ed25519 precommits and BLS
    dual-signs) through one VerifyScheduler over the process verifier, on
    the native pairing and then the card's (BLS_GATE=1); the tool asserts
    every verdict. Launch counts zeroed before each route, read after."""
    from tendermint_tpu_torch.tools import qc_bench

    launches, walls = {}, {}
    gate = os.environ.pop(BLS_GATE, None)
    try:
        for route in ("native", "device"):
            if route == "device":
                os.environ[BLS_GATE] = "1"
            t0 = time.perf_counter()
            ops.reset_launches()
            res = qc_bench.run_qc_catchup(device="cuda")
            torch.cuda.synchronize()
            got = ops.kernel_launches()
            walls[route] = time.perf_counter() - t0
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            # the committees' tables are built on the first route and kept
            for name in ("verify_prehashed_table", "verify_prehashed_bigcache") + (
                    ("neg_pubkey_table", "neg_pubkey_bigtable") if route == "native" else ()):
                assert got[name] > 0, f"harnesses (b) {route}: {name} was not launched"
            if route == "device":
                assert got["miller"] > 0 and got["final_exp"] > 0, got
            else:
                assert got["miller"] == got["final_exp"] == 0, got
            per = {r["validators"]: (r["baseline_wall_per_block_ms"], r["qc_wall_per_block_ms"],
                                     r["proof_compression"], r["qc_rounds"]) for r in res["rows"]}
            print(f"main path: harnesses (b) QC catch-up, {route} pairing: ms a block "
                  f"(baseline verify_commits_light, QC verify_commits_qc), proof compression, QC "
                  f"rounds by committee {json.dumps(per)}; QC flatness {res['qc_flatness']}, "
                  f"baseline growth {res['baseline_growth']}, compression at "
                  f"{max(HARNESS_SIZES)} {res['proof_compression_at_max']}; every verdict true; "
                  f"launches {json.dumps({k: v for k, v in got.items() if v})}; "
                  f"{walls[route]:.1f} s | {smi}")
    finally:
        os.environ.pop(BLS_GATE, None)
        if gate is not None:
            os.environ[BLS_GATE] = gate
    return launches, walls


def replay_window(torch, ops, smi) -> tuple:
    """Phase 15 (c): tools/bench_replay.py at its defaults, 64 commits x
    128 validators through verify_commits_light in one window and then
    block by block, `--device cuda`, in this process (its command line
    handed in; the tool asserts every verdict). Launch counts zeroed
    before, read after."""
    import contextlib
    import importlib
    import io

    argv = sys.argv
    sys.argv = ["bench_replay", "--device", "cuda"]
    try:
        sys.modules.pop("tendermint_tpu_torch.tools.bench_replay", None)
        tool = importlib.import_module("tendermint_tpu_torch.tools.bench_replay")
    finally:
        sys.argv = argv
    assert (tool.BLOCKS, tool.VALS, tool.DEVICE) == (64, 128, "cuda")
    out = io.StringIO()
    t0 = time.perf_counter()
    ops.reset_launches()
    with contextlib.redirect_stdout(out):
        tool.main()
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    wall = time.perf_counter() - t0
    for name in ("neg_pubkey_bigtable", "verify_prehashed_bigcache", "verify_prehashed_table"):
        assert launches[name] > 0, f"harnesses (c): {name} was not launched"
    lines = [ln for ln in out.getvalue().splitlines() if not ln.startswith("#")]
    assert len(lines) == 3 and "for 8192 sigs" in lines[0], lines
    print(f"main path: harnesses (c) bench_replay {tool.BLOCKS} x {tool.VALS}: "
          f"{' | '.join(lines)}; every verdict true; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; {wall:.1f} s | {smi}")
    return launches, wall


def soak_child(smi) -> float:
    """Phase 15 (d): `python -m tendermint_tpu_torch.tools.soak --iters 1
    --seed SOAK_SEED --device cuda` as a child: the seeded random chaos
    scenario on a 4-validator in-proc mesh, every node on the child's
    process verifier on the card. Exit 0 and `ok`; its launches are in the
    child, not counted."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "tendermint_tpu_torch.tools.soak", "--iters", "1",
         "--seed", str(SOAK_SEED), "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=SOAK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    assert out.returncode == 0, f"harnesses (d): soak exit {out.returncode}: {out.stderr[-3000:]}"
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["ok"] is True and doc["iterations"] == 1, doc
    res = doc["results"][0]
    assert res["ok"] and res["forks"] == 1, res
    att = res["latency_attribution"]["steps"]
    print(f"main path: harnesses (d) soak, seed {res['seed']}, 4 validators: ok, heights "
          f"{json.dumps(res['heights'])}, forks {res['forks']}, health "
          f"{json.dumps(res['health'])}; cs.commit p50 {att.get('cs.commit', {}).get('p50_ms')} "
          f"ms; the child's wall {wall:.1f} s (its torch import and kernel load included; its "
          f"launches are in the child, not counted) | {smi}")
    return wall


def harness_phase(torch, ops, smi) -> dict:
    """Phase 15: the port's harnesses at their own sizes (a-d). Returns the
    in-process launches per kernel ((b) and (c); (a) and (d) run in
    children)."""
    t0 = time.perf_counter()
    wall_a = service_family(smi)
    qc_launches, qc_walls = qc_catchup(torch, ops, smi)
    replay_launches, wall_c = replay_window(torch, ops, smi)
    wall_d = soak_child(smi)
    launches = {k: qc_launches.get(k, 0) + replay_launches.get(k, 0)
                for k in set(qc_launches) | set(replay_launches)}
    print(f"time: harnesses: (a) {wall_a:.1f} s, (b) native {qc_walls['native']:.1f} s, device "
          f"{qc_walls['device']:.1f} s, (c) {wall_c:.1f} s, (d) {wall_d:.1f} s; phase 15 "
          f"{time.perf_counter() - t0:.1f} s | {smi}")
    return launches



# --- the multi-device path: a mesh of shards ---------------------------------

# shards of the mesh phase: the JAX tests' mesh size (tests/conftest.py)
MESH_SHARDS = 8


def counted(torch, ops, acc, fn, *args):
    """fn(*args) with the launch counts set to 0 just before and read just
    after (the card synchronised); they are added to acc."""
    ops.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    for name, n in ops.kernel_launches().items():
        acc[name] = acc.get(name, 0) + n
    return out


BRANCH_PAIRS = ("p + q", "p at infinity", "q at infinity", "p = q, two representations",
                "p = -q", "p = q with y = 0", "p = q")


def branch_pairs(g: str, k0, k1):
    """(p, q) host point lists of G1 (`g` "g1") or G2 ("g2"), one pair for
    each case of BRANCH_PAIRS (every branch of the complete addition),
    from two points k0, k1 of the group."""
    from tendermint_tpu_torch.crypto import bls12_381 as c

    if g == "g2":
        mul, neg, inf, lam, zero = c.f2_mul, c.g2_neg, c.G2_INF, (3, 5), (0, 0)
    else:
        mul, neg, inf, lam, zero = (lambda a, b: a * b % c.P), c.g1_neg, c.G1_INF, 7, 0
    l2 = mul(lam, lam)
    other = (mul(k0[0], l2), mul(k0[1], mul(l2, lam)), mul(k0[2], lam))
    y0 = (k0[0], zero, k0[2])
    return ([k0, inf, k0, k0, k0, y0, k0],
            [k1, k0, inf, other, neg(other), y0, k0])


def sharded_sums(torch, ops, mesh, point_sets, acc, errs, label) -> None:
    """Kernel 13 (g1/g2_aggregate_sharded) over `mesh` at three sizes,
    held against its plain version (the same schedule on the CPU, byte
    for byte) and the host sum (affine)."""
    from tendermint_tpu_torch.crypto import bls12_381 as c
    from tendermint_tpu_torch.ops import bls_g1, bls_g2

    groups = {
        "g1": (bls_g1.g1_aggregate_sharded, bls_g1.g1_aggregate_sharded_plain,
               bls_g1.g1_to_host, c.g1_add, c.G1_INF, c.g1_eq),
        "g2": (bls_g2.g2_aggregate_sharded, bls_g2.g2_aggregate_sharded_plain,
               bls_g2.g2_to_host, c.g2_add, c.G2_INF, c.g2_eq),
    }
    sizes = []
    for g, (kern, plain, to_host, add, inf, eq) in groups.items():
        first = point_sets[g][0]
        cases = point_sets[g] + [("5 points (fewer than the shards)",
                                  first[1][:5], first[2][:5])]
        for what, pts, host_pts in cases:
            got = counted(torch, ops, acc, kern, pts, mesh)
            err = max_abs_err(got, plain(pts.cpu(), mesh))
            errs[g + "_add"] = max(errs.get(g + "_add", 0), err)
            assert err == 0, f"{g}_aggregate_sharded != plain ({what}, {label})"
            want = inf
            for p in host_pts:
                want = add(want, p)
            assert eq(to_host(got), want), f"{g}_aggregate_sharded != host ({what}, {label})"
            sizes.append(f"{g} {what}")
    print(f"kernel-vs-plain: {label}: g1/g2_aggregate_sharded equal their plain "
          f"versions (the schedule on the CPU; tolerance: exact bytes) and the "
          f"host sums (affine) on {'; '.join(sizes)}")


def mesh_window(torch, ops, host, rng, acc, verifier, vset, chain_id, entries,
                tampered, bad_height, one, reps, label, shards):
    """The blocksync window through a started VerifyScheduler over a mesh
    verifier: run_window's checks, plus the verdicts and the per-row
    bitmap equal to the 1-device run's (`one`, byte for byte), every round
    stamped with the mesh's shards and sharded, and the scheduler's
    verify_mesh_devices gauge reading them. Returns the walls and the
    round's launches."""
    from tendermint_tpu_torch.libs.metrics import Registry, SchedulerMetrics

    metrics = SchedulerMetrics(Registry("smoke_" + label))
    ops.reset_launches()
    verdicts, walls, _, bitmap, items, ledger = run_window(
        verifier, vset, chain_id, entries, reps, label, metrics)
    torch.cuda.synchronize()
    counts = ops.kernel_launches()
    for name, n in counts.items():
        acc[name] = acc.get(name, 0) + n
    check_window(host, verdicts, bitmap, items, ledger, len(entries), bad_height,
                 tampered, len(vset.validators), rng, label)
    assert verdicts == one["verdicts"], f"{label}: verdicts != the 1-device window's"
    assert bitmap == one["bitmap"], f"{label}: bitmap != the 1-device window's"
    b = verifier._registry.bucket_for(len(items), multiple_of=shards)
    for e in ledger:
        assert e["devices"] == shards and e["sharded"] and e["dispatched"] == b, e
    assert metrics.mesh_devices.value() == shards, metrics.mesh_devices.value()
    return walls, {k: n for k, n in counts.items() if n}


def mesh_phase(torch, np, rng, dev, smi, ops, host, vset, chain_id, entries,
               tampered, bad_height, bulk, g_items, point_sets, secp_arrays):
    """Phase 8: the multi-device path over MESH_SHARDS shards on `dev`,
    then over every card where there are two or more. Returns the rows of
    the butterfly add kernels, the path's launches per kernel and the
    sharded sums' ms {"g1"|"g2": ms}."""
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry
    from tendermint_tpu_torch.ops import bls_g1, bls_g2
    from tendermint_tpu_torch.ops import secp256k1_kernel as sk
    from tendermint_tpu_torch.parallel import build_mesh
    from tendermint_tpu_torch.parallel.mesh import Mesh, shard_rows

    mesh = Mesh([dev] * MESH_SHARDS)
    acc, errs = {}, {}
    label = f"mesh of {MESH_SHARDS} shards on {mesh.devices.flat[0]}"

    # --- kernel 13 at three sizes, against its plain version and the host
    sharded_sums(torch, ops, mesh, point_sets, acc, errs, label)

    # --- the blocksync window on the mesh, host- and card-hashed and MXU
    m_host = bv.BatchVerifier(mesh=mesh, shape_registry=ShapeRegistry())
    m_dev = bv.BatchVerifier(mesh=mesh, device_challenge_min=2048,
                             shape_registry=ShapeRegistry())
    os.environ["TM_TPU_MXU_GATHER"] = "1"
    m_mxu = bv.BatchVerifier(mesh=mesh, shape_registry=ShapeRegistry())
    del os.environ["TM_TPU_MXU_GATHER"]
    n_rows = len(entries) * len(vset.validators)
    walls = {}
    for name, verifier, reps, path_kernels in (
        ("host_hash", m_host, 2, ("neg_pubkey_bigtable", "verify_prehashed_bigcache")),
        ("device_hash", m_dev, 2, ("challenge_batch", "verify_prehashed_bigcache")),
        ("mxu_gather", m_mxu, 1, ("verify_prehashed_bigcache_mxu",)),
    ):
        if verifier is not m_host:
            verifier._big = m_host._big  # the window's tables, built once
        walls[name], counts = mesh_window(
            torch, ops, host, rng, acc, verifier, vset, chain_id, entries, tampered,
            bad_height, bulk[name], reps, "mesh_" + name, MESH_SHARDS)
        for k in path_kernels:
            assert counts.get(k, 0) >= MESH_SHARDS, f"{k} not launched per shard ({name})"
        print(f"main path: mesh bulk {name}: {len(entries)} commits x "
              f"{len(vset.validators)} validators = {n_rows} rows over {label}, "
              f"bucket {m_host._registry.bucket_for(n_rows, MESH_SHARDS)} "
              f"({m_host._registry.bucket_for(n_rows, MESH_SHARDS) // MESH_SHARDS} rows a "
              f"shard); verdicts and per-row bitmap = the 1-device window's x{reps}; "
              f"rounds stamped devices={MESH_SHARDS}, sharded; verify_mesh_devices "
              f"gauge {MESH_SHARDS}; launches {json.dumps(counts)}")

    # a 150-row round, below mesh_min_rows, stays on one device
    ops.reset_launches()
    verdicts, _, _, bitmap, items, ledger = run_window(
        m_host, vset, chain_id, entries[:1], 1, "mesh_one_commit")
    torch.cuda.synchronize()
    one_commit = {k: n for k, n in ops.kernel_launches().items() if n}
    for k, n in one_commit.items():
        acc[k] = acc.get(k, 0) + n
    assert verdicts == [[True]] and all(bitmap), verdicts
    assert bitmap == bulk["host_hash"]["bitmap"][: len(items)]
    for e in ledger:
        assert e["devices"] == 1 and not e["sharded"] and e["rows"] == {
            "blocksync": len(items)}, e
    assert one_commit.get("neg_pubkey_table", 0) == MESH_SHARDS, one_commit
    print(f"main path: mesh one commit ({len(items)} rows, below mesh_min_rows "
          f"{m_host._mesh_min_rows}): rounds stamped devices=1 on the small tier; "
          f"its table build sharded; launches {json.dumps(one_commit)}")

    # the small and generic families sharded (mesh_min_rows=1): the commit
    # round of phase 3 with its tampered row
    want = [host.verify(it.pubkey, it.msg, it.sig) for it in g_items]
    solo = bv.BatchVerifier(shape_registry=ShapeRegistry(), device=dev).verify(
        g_items).tolist()
    assert solo == want
    for tier, kw in (("small", {}), ("generic", {"table_cache_capacity": 64})):
        v = bv.BatchVerifier(mesh=mesh, mesh_min_rows=1, shape_registry=ShapeRegistry(), **kw)
        prep = v.prepare(g_items)
        assert prep.devices == MESH_SHARDS
        got = counted(torch, ops, acc, prep.run).tolist()
        assert got == want, f"sharded {tier} round != host oracle"
        (shape,) = v._registry.shapes_by_tier()[tier]
        assert shape[2] == MESH_SHARDS, shape
    print(f"main path: the {len(g_items)}-row commit round (one tampered row) "
          f"sharded over {label} on the small tier and the generic kernel "
          f"(mesh_min_rows=1) = the host oracle = the 1-device verifier")

    # prewarm_buckets on the mesh verifier: both device variants where the
    # ladder lets them
    entries_pw = counted(torch, ops, acc, m_host.prewarm_buckets)
    variants = {}
    for e in entries_pw:
        variants.setdefault(e["bucket"], set()).add(e["devices"])
    ladder = m_host._registry.ladder
    for i, b in enumerate(ladder):
        prev = ladder[i - 1] if i else 0
        want_v = {d for d, ok in ((1, prev + 1 < m_host._mesh_min_rows),
                                  (MESH_SHARDS, b >= m_host._mesh_min_rows)) if ok}
        assert variants[b] == want_v, (b, variants)
    assert any(len(v) == 2 for v in variants.values()), variants
    print(f"main path: prewarm_buckets on the mesh verifier (rungs {list(ladder)}, "
          f"mesh_min_rows {m_host._mesh_min_rows}): {json.dumps(entries_pw)}")

    # the sharded secp256k1 launch: the mixed window's rows
    n_live = int(secp_arrays[5].sum())
    one_dev = sk.verify_prehashed(*(torch.from_numpy(a).to(dev) for a in secp_arrays))
    got = counted(torch, ops, acc, shard_rows, sk.verify_prehashed, mesh, secp_arrays)
    assert got.tolist() == one_dev.cpu().tolist(), "sharded secp256k1 != unsharded"
    print(f"main path: secp_verify_prehashed sharded over {label}: "
          f"{len(got)} rows ({n_live} live) = the unsharded launch's bitmap")

    # --- timings
    sig_pts, key_pts = point_sets["g1"][0][1], point_sets["g2"][0][1]
    rows, sharded_ms = [], {}
    for g, add, add_plain, kern, plain, pts, fp_add, per_coord in (
        ("g1", bls_g1.g1_add, bls_g1.g1_add_plain, bls_g1.g1_aggregate_sharded,
         bls_g1.g1_aggregate_sharded_plain, sig_pts, FP_G1_ADD, 1),
        ("g2", bls_g2.g2_add, bls_g2.g2_add_plain, bls_g2.g2_aggregate_sharded,
         bls_g2.g2_aggregate_sharded_plain, key_pts, FP_G2_ADD, 2),
    ):
        b = pts.shape[0]
        # every branch of the addition in one launch: the lane groups (G1)
        # or warps (G2) of one launch take different branches
        hosts = point_sets[g][0][2]
        to_dev = bls_g1.g1_from_host if g == "g1" else bls_g2.g2_from_host
        bp, bq = (torch.stack([to_dev(x) for x in side]).to(dev)
                  for side in branch_pairs(g, hosts[0], hosts[1]))
        err = max_abs_err(add(bp, bq), add_plain(bp, bq))
        assert err == 0, f"{g}_add != plain on the branch pairs"
        # one butterfly launch: one pair, as every round adds per shard
        p, q = pts[:1].contiguous(), pts[1:2].contiguous()
        got = add(p, q)
        want, plain_ms = time_once(torch, add_plain, p, q)
        err = max(err, max_abs_err(got, want))
        assert err == 0, f"{g}_add != plain"
        errs[g + "_add"] = max(errs[g + "_add"], err)
        ms = time_cuda(torch, lambda: add(p, q), 20)
        point_bytes = p.numel()
        b_ms, b_by = bound_ms(3 * point_bytes, (fp_add + 9 * per_coord) * IMAD_PER_FP_MUL)
        rows.append({
            "name": f"{g}_add", "route": "cuda", "source": BLS_SOURCE,
            "replaces": "tendermint_tpu/ops/shard_reduce.py:48",
            "launches": acc.get(f"{g}_add", 0), "max_abs_err": errs[g + "_add"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        print(f"time: {g}_add kernel (one butterfly launch, 1 pair) {ms:.4f} ms plain "
              f"{plain_ms:.2f} ms (one call) bound {b_ms:.3g} ms ({b_by}) | {smi}")
        sum_ms = sharded_ms[g] = time_cuda(torch, lambda: kern(pts, mesh), 20)
        t0 = time.perf_counter()
        plain(pts.cpu(), mesh)
        sum_plain_ms = (time.perf_counter() - t0) * 1e3
        s_ms, s_by = bound_ms(pts.numel() + point_bytes,
                              ((b - 1) * fp_add + 3 * per_coord * (b + 1)) * IMAD_PER_FP_MUL)
        rounds = MESH_SHARDS.bit_length() - 1
        print(f"time: {g}_aggregate_sharded (kernel 13) of {b} points over {label}: "
              f"{sum_ms:.4f} ms ({MESH_SHARDS} tree launches + {MESH_SHARDS * rounds} "
              f"add launches, median of 20 by CUDA events); plain on the CPU "
              f"{sum_plain_ms:.2f} ms (one call, host clock); bound {s_ms:.3g} ms "
              f"({s_by}, the {b - 1} additions any sum of {b} points needs) | {smi}")
    win_1 = {k: [round(w * 1e3, 2) for w in bulk[k]["walls"]] for k in walls}
    win_m = {k: [round(w * 1e3, 2) for w in v] for k, v in walls.items()}
    print(f"time: blocksync window ms, {label} {json.dumps(win_m)} against one "
          f"device {json.dumps(win_1)} | {smi}")
    d_arrays = [torch.from_numpy(a).to(dev) for a in secp_arrays]
    secp_one = time_cuda(torch, lambda: sk.verify_prehashed(*d_arrays), 20)
    secp_sh = time_cuda(
        torch, lambda: shard_rows(sk.verify_prehashed, mesh, secp_arrays), 5)
    print(f"time: secp_verify_prehashed {len(secp_arrays[0])} rows: one launch "
          f"{secp_one:.4f} ms (operands on the card); sharded over {label} "
          f"{secp_sh:.4f} ms (copies, {MESH_SHARDS} launches, the gather; median of 5) "
          f"| {smi}")

    # --- a real mesh: every card, where there are two or more
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print("mesh: real multi-GPU mesh not run (1 device)")
        return rows, acc, sharded_ms
    real = build_mesh(0, 1, "cuda")
    label = f"mesh of {real.size} cards"
    sharded_sums(torch, ops, real, point_sets, acc, errs, label)
    r_host = bv.BatchVerifier(mesh=real, shape_registry=ShapeRegistry())
    r_walls, counts = mesh_window(
        torch, ops, host, rng, acc, r_host, vset, chain_id, entries, tampered,
        bad_height, bulk["host_hash"], 2, "real_mesh_host_hash", real.size)
    got = counted(torch, ops, acc, shard_rows, sk.verify_prehashed, real, secp_arrays)
    assert got.tolist() == one_dev.cpu().tolist(), "sharded secp256k1 != unsharded (cards)"
    print(f"main path: {label}: kernel 13 at the three sizes, the host-hashed window "
          f"(= the 1-device window, rounds stamped devices={real.size}) and the "
          f"sharded secp256k1 launch pass; window walls "
          f"{[round(w * 1e3, 2) for w in r_walls]} ms; launches {json.dumps(counts)} "
          f"| {smi}")
    return rows, acc, sharded_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--validators", type=int, default=150)
    ap.add_argument("--heights", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tendermint_tpu_torch import ops, types
    from tendermint_tpu_torch.crypto import batch_verifier as bv
    from tendermint_tpu_torch.crypto import ed25519 as host
    from tendermint_tpu_torch.crypto.shape_registry import ShapeRegistry
    from tendermint_tpu_torch.ops import _build, curve25519 as curve
    from tendermint_tpu_torch.ops import dbl_chain as dc
    from tendermint_tpu_torch.ops import ed25519_batch as eb
    from tendermint_tpu_torch.ops import field25519 as fe
    from tendermint_tpu_torch.ops import sha512

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    # each phase's wall, against the chip tool's limit on the whole run
    phase_walls, lap_at = {}, [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        phase_walls[phase], lap_at[0] = round(now - lap_at[0], 1), now

    # --- 1. build -----------------------------------------------------------
    smi = nvidia_smi_line()
    ptxas = _build.start_ptxas_report()
    t0 = time.perf_counter()
    _build.kernels()
    build_s = time.perf_counter() - t0
    report = _build.finish_ptxas_report(ptxas)
    with open(os.path.join(_build.BUILD_DIR, "ptxas_report.txt"), "w") as f:
        f.write(report)
    print(f"build: route={_build.BUILD_INFO['route']} seconds={build_s:.1f} | {smi}")
    usages = ptxas_usage(report)
    for name, usage in usages.items():
        print(f"ptxas: {name}: {usage}")

    def T(rows) -> torch.Tensor:
        return torch.tensor([list(r) for r in rows], dtype=torch.uint8)

    lap("1 build")

    # --- 2. kernel vs plain -------------------------------------------------
    keys = [host.PrivKey(rng.bytes(32)) for _ in range(200)]
    adversarial = [
        (1).to_bytes(32, "little"),  # identity (small order)
        bytes(32),  # y = 0: order-4 point
        ((1 << 255) | 1).to_bytes(32, "little"),  # y = 1, x = 0, sign set
        host.P.to_bytes(32, "little"),  # y = p, non-canonical
        (host.P + 1).to_bytes(32, "little"),  # y = p + 1, non-canonical
        (2**255 - 1).to_bytes(32, "little"),  # y = 2^255 - 1
        (host.P - 1).to_bytes(32, "little"),  # y = -1: order-2 point
    ]
    pubs = [k.public_key().data for k in keys] + adversarial
    while len(pubs) < 256:
        pubs.append(rng.bytes(32))  # about half have no square root
    pub_d = T(pubs).to(dev)
    tables, tvalid = eb.neg_pubkey_table(pub_d)
    p_tables, p_tvalid = eb.neg_pubkey_table_plain(pub_d)
    torch.cuda.synchronize()
    errs = {"neg_pubkey_table": max(max_abs_err(tables, p_tables),
                                    max_abs_err(tvalid, p_tvalid))}
    assert errs["neg_pubkey_table"] == 0, "neg_pubkey_table: kernel != plain"
    want_valid = [host.point_decompress(p) is not None for p in pubs]
    assert tvalid.cpu().tolist() == want_valid, "neg_pubkey_table validity"
    k2_sets = kernel2_key_sets(torch, pub_d, len(keys))
    for n, (pk, order) in k2_sets.items():
        got_t, got_v = eb.neg_pubkey_table(pk)
        plain_t, plain_v = eb.neg_pubkey_table_plain(pk)
        torch.cuda.synchronize()
        err = max(max_abs_err(got_t, plain_t), max_abs_err(got_v, plain_v))
        errs["neg_pubkey_table"] = max(errs["neg_pubkey_table"], err)
        assert err == 0, f"neg_pubkey_table: kernel != plain at {n} keys"
        assert got_v.cpu().tolist() == [want_valid[i] for i in order], (
            f"neg_pubkey_table validity at {n} keys")
    print(f"kernel-vs-plain: neg_pubkey_table (four lanes a key) at "
          f"{list(k2_sets)} keys, adversarial keys and keys with no square root "
          f"inside warps of valid ones: equal to its plain version byte for byte "
          f"and its validity to the host oracle (tolerance: exact) "
          f"{json.dumps({n: sum(want_valid[i] for i in o) for n, (_, o) in k2_sets.items()})}")

    # 256 verify rows over these keys, the last 8 padding
    n_rows = 256
    items, idx, want = mixed_rows(host, keys, pubs, n_rows, 8, b"smoke")
    R, S, K, s_ok, idx_t = row_tensors(torch, host, items, idx, 8, dev)
    vt = eb.verify_prehashed_table(tables, tvalid, idx_t, R, S, K, s_ok)
    vt_plain = eb.verify_prehashed_table_plain(tables, tvalid, idx_t, R, S, K, s_ok)
    torch.cuda.synchronize()
    errs["verify_prehashed_table"] = max_abs_err(vt, vt_plain)
    assert errs["verify_prehashed_table"] == 0, "verify_prehashed_table: kernel != plain"
    assert vt.cpu().tolist() == want, "verify_prehashed_table != host oracle"
    assert any(want) and not all(want)
    k3_checks = []
    for b, n_pad in KERNEL3_SIZES:
        k3_ops, k3_want = kernel3_rows(torch, host, keys, pubs, tables, tvalid,
                                       b, n_pad, b"k3-%d" % b)
        got = eb.verify_prehashed_table(*k3_ops)
        plain = eb.verify_prehashed_table_plain(*k3_ops)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        errs["verify_prehashed_table"] = max(errs["verify_prehashed_table"], err)
        assert err == 0, f"verify_prehashed_table: kernel != plain at b={b}"
        assert got.cpu().tolist() == k3_want, f"verify_prehashed_table != host oracle at b={b}"
        k3_checks.append({"b": b, "padding": n_pad, "accepted": sum(k3_want)})
    print(f"kernel-vs-plain: verify_prehashed_table (four lanes a row) at its "
          f"small-tier shapes, idx -1 and past the store inside warps of live "
          f"rows: equal to its plain version and the host oracle (tolerance: "
          f"exact) {json.dumps(k3_checks)}")
    G_pub = T([p for p, _, _ in items]).to(dev)
    vg = eb.verify_prehashed(G_pub, R, S, K, s_ok)
    vg_plain = eb.verify_prehashed_plain(G_pub, R, S, K, s_ok)
    torch.cuda.synchronize()
    errs["verify_prehashed"] = max_abs_err(vg, vg_plain)
    assert errs["verify_prehashed"] == 0, "verify_prehashed: kernel != plain"
    assert vg.cpu().tolist() == want, "verify_prehashed != host oracle"
    k4_checks = []
    for b, n_pad in KERNEL3_SIZES:
        k4_ops, k4_want = kernel4_rows(torch, host, keys, pubs, b, n_pad, b"k4-%d" % b, dev)
        got = eb.verify_prehashed(*k4_ops)
        plain = eb.verify_prehashed_plain(*k4_ops)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        errs["verify_prehashed"] = max(errs["verify_prehashed"], err)
        assert err == 0, f"verify_prehashed: kernel != plain at b={b}"
        assert got.cpu().tolist() == k4_want, f"verify_prehashed != host oracle at b={b}"
        k4_checks.append({"b": b, "padding": n_pad, "accepted": sum(k4_want)})
    print(f"kernel-vs-plain: verify_prehashed (four lanes a row) on 256 mixed "
          f"rows and at the small-tier shapes, padding rows and s_ok False "
          f"inside warps of live rows: equal to its plain version and the host "
          f"oracle (tolerance: exact) {json.dumps(k4_checks)}")

    # the big tier: 256 tables, 2048 rows (the last 64 padding)
    btables, bvalid = eb.neg_pubkey_bigtable(pub_d)
    p_btables, p_bvalid = eb.neg_pubkey_bigtable_plain(pub_d)
    torch.cuda.synchronize()
    errs["neg_pubkey_bigtable"] = max(max_abs_err(btables, p_btables),
                                      max_abs_err(bvalid, p_bvalid))
    assert errs["neg_pubkey_bigtable"] == 0, "neg_pubkey_bigtable: kernel != plain"
    assert bvalid.cpu().tolist() == want_valid, "neg_pubkey_bigtable validity"
    del p_btables
    big_items, big_idx, big_want = mixed_rows(host, keys, pubs, 2048, 64, b"big")
    bR, bS, bK, b_ok, bidx_t = row_tensors(torch, host, big_items, big_idx, 64, dev)
    big_args = (btables, bvalid, bidx_t, bR, bS, bK, b_ok)
    for name, kern, plain in (
        ("verify_prehashed_bigcache", eb.verify_prehashed_bigcache,
         eb.verify_prehashed_bigcache_plain),
        ("verify_prehashed_bigcache_mxu", eb.verify_prehashed_bigcache_mxu,
         eb.verify_prehashed_bigcache_mxu_plain),
    ):
        got = kern(*big_args)
        got_plain = plain(*big_args)
        torch.cuda.synchronize()
        errs[name] = max_abs_err(got, got_plain)
        assert errs[name] == 0, f"{name}: kernel != plain"
        assert got.cpu().tolist() == big_want, f"{name} != host oracle"
    assert any(big_want) and not all(big_want)

    # challenges: 2048 ragged rows of R || A || M, 0..1000-byte messages
    ch_rows = [(rng.bytes(32), rng.bytes(32), rng.bytes(int(n)))
               for n in rng.integers(0, 1001, 2048)]
    ch_buf, ch_cnt = sha512.pad_messages(
        [m for _, _, m in ch_rows], prefix_pairs=[r + a for r, a, _ in ch_rows]
    )
    ch_buf_d = torch.from_numpy(ch_buf).to(dev)
    ch_cnt_d = torch.from_numpy(ch_cnt).to(dev)
    ch_want = [(int.from_bytes(hashlib.sha512(r + a + m).digest(), "little") % host.L)
               .to_bytes(32, "little") for r, a, m in ch_rows]
    errs["challenge_batch"] = 0
    for n in (len(ch_rows), KERNEL8_PARTIAL):
        ch = sha512.challenge_batch(ch_buf_d[:n], ch_cnt_d[:n])
        ch_plain = sha512.challenge_batch_plain(ch_buf_d[:n], ch_cnt_d[:n])
        torch.cuda.synchronize()
        err = max_abs_err(ch, ch_plain)
        errs["challenge_batch"] = max(errs["challenge_batch"], err)
        assert err == 0, f"challenge_batch: kernel != plain at {n} rows"
        assert [bytes(r) for r in ch.cpu().tolist()] == ch_want[:n], (
            f"challenge_batch != hashlib + % L at {n} rows")
    print(f"kernel-vs-plain: challenge_batch (a warp stages its rows' blocks) at "
          f"{len(ch_rows)} ragged rows of {ch_buf.shape[1] // 128} blocks "
          f"({int(ch_cnt.min())}-{int(ch_cnt.max())} a row) and their first "
          f"{KERNEL8_PARTIAL} (a partial last warp): equal to its plain version and "
          f"hashlib + % L (tolerance: exact)")
    # the reduction alone, on digests SHA-512 cannot be made to give
    L = host.L
    digests = [2**512 - 1, L - 1, L, L + 1, 2 * L, 2 * L - 1, 2**252, 0, 1,
               2**256 - 1, (2**512 - 1) // L * L, (2**512 - 1) // L * L - 1]
    digests += [int.from_bytes(rng.bytes(64), "little") for _ in range(1012)]
    dig_d = T([v.to_bytes(64, "little") for v in digests]).to(dev)
    red = sha512.reduce_mod_l(dig_d)
    red_plain = sha512.reduce_mod_l_plain(dig_d)
    torch.cuda.synchronize()
    reduce_err = max_abs_err(red, red_plain)
    assert reduce_err == 0, "reduce_mod_l: kernel != plain"
    assert [int.from_bytes(bytes(r), "little") for r in red.cpu().tolist()] == [
        v % L for v in digests
    ], "reduce_mod_l != int % L"

    # 8192 points [c_i]B, doubled 256 times
    n_pts, n_dbl = 8192, dc.N_DBL
    scalars = torch.from_numpy(rng.integers(0, 256, (n_pts, 32), dtype=np.uint8))
    scalars[0] = 0
    scalars[0, 0] = 1  # row 0 is the basepoint
    pts = fe.to_bytes(curve.scalar_mult_base(scalars.to(dev))).contiguous()
    d_out = dc.dbl_chain(pts, n_dbl)
    d_plain = dc.dbl_chain_plain(pts, n_dbl)
    # a partial last warp: the group of four lanes a point ends mid-warp
    d_part = dc.dbl_chain(pts[:KERNEL1_PARTIAL], n_dbl)
    torch.cuda.synchronize()
    errs["dbl_chain"] = max(max_abs_err(d_out, d_plain),
                            max_abs_err(d_part, d_plain[:KERNEL1_PARTIAL]))
    assert errs["dbl_chain"] == 0, "dbl_chain: kernel != plain (bytes)"

    def affine(p8):
        p = fe.from_bytes(p8)
        zi = fe.invert(p[:, 2])
        return fe.to_bytes(fe.mul(p[:, :2], zi.unsqueeze(1)))

    assert torch.equal(affine(d_out), affine(d_plain)), "dbl_chain affine"
    hq = host.BASEPOINT
    for _ in range(n_dbl):
        hq = host.point_double(hq)
    zi = pow(hq[2], host.P - 2, host.P)
    want0 = [hq[0] * zi % host.P, hq[1] * zi % host.P]
    got0 = [int.from_bytes(bytes(r), "little") for r in affine(d_out)[0].cpu().tolist()]
    assert got0 == want0, "dbl_chain row 0 != host oracle"
    print(f"kernel-vs-plain: all eight wrappers and the reduction kernel "
          f"equal their plain versions (tolerance: exact; reduce_mod_l on "
          f"{len(digests)} digests, max_abs_err {reduce_err})")

    lap("2 kernel vs plain")

    # --- 3. main paths ------------------------------------------------------
    chain_id = "chip-smoke"
    vkeys = [host.PrivKey(rng.bytes(32)) for _ in range(args.validators)]
    powers = rng.integers(1, 100, args.validators).tolist()
    vset = types.ValidatorSet(
        [types.Validator(k.public_key(), int(p)) for k, p in zip(vkeys, powers)]
    )
    by_addr = {k.public_key().address(): k for k in vkeys}

    def signed_commit(height: int):
        bid = types.BlockID(
            hash=rng.bytes(32),
            part_set_header=types.PartSetHeader(total=1, hash=rng.bytes(32)),
        )
        sigs = [
            types.CommitSig(types.BlockIDFlag.COMMIT, v.address,
                            1_700_000_000_000_000_000 + height * 10**9 + i)
            for i, v in enumerate(vset.validators)
        ]
        commit = types.Commit(height, 0, bid, sigs)
        for i, v in enumerate(vset.validators):
            sigs[i].signature = by_addr[v.address].sign(
                commit.vote_sign_bytes(chain_id, i)
            )
        return bid, commit

    # commit verification
    commits = [signed_commit(h) for h in range(1, args.heights + 2)]
    ops.reset_launches()
    verifier = bv.default_verifier()
    assert verifier.device.type == "cuda"
    commit_ms = []
    for h, (bid, commit) in enumerate(commits[: args.heights], start=1):
        t0 = time.perf_counter()
        vset.verify_commit(chain_id, bid, h, commit)
        commit_ms.append((time.perf_counter() - t0) * 1e3)
    bid, commit = commits[-1]
    h_bad = args.heights + 1
    bad_i = int(rng.integers(0, args.validators))
    sig = commit.signatures[bad_i].signature
    commit.signatures[bad_i].signature = sig[:3] + bytes([sig[3] ^ 1]) + sig[4:]
    try:
        vset.verify_commit(chain_id, bid, h_bad, commit)
    except ValueError as e:
        assert str(e) == f"wrong signature at index {bad_i}", e
    else:
        raise AssertionError("tampered commit verified")
    small = bv.BatchVerifier(table_cache_capacity=64)
    g_items = [
        bv.SigItem(vset.validators[i].pub_key.data,
                   commit.vote_sign_bytes(chain_id, i),
                   commit.signatures[i].signature)
        for i in range(args.validators)
    ]
    got = small.verify(g_items).tolist()
    assert got == [host.verify(it.pubkey, it.msg, it.sig) for it in g_items]
    assert got.count(False) == 1 and not got[bad_i]
    launches = {}
    commit_launches = ops.kernel_launches()
    for name in ("neg_pubkey_table", "verify_prehashed_table", "verify_prehashed"):
        assert commit_launches[name] > 0, f"{name} was not launched on its main path"
        launches[name] = commit_launches[name]
    print(f"main path: verify_commit x{args.heights} at {args.validators} "
          f"validators ok; tampered index {bad_i} rejected; generic round ok; "
          f"launches {json.dumps({k: v for k, v in commit_launches.items() if v})}")

    # the doubling chain
    ops.reset_launches()
    dc.dbl_chain(pts, n_dbl)
    torch.cuda.synchronize()
    launches["dbl_chain"] = ops.kernel_launches()["dbl_chain"]
    assert launches["dbl_chain"] > 0, "dbl_chain was not launched on its main path"

    # bulk commit verification: one blocksync window through the scheduler
    n_win = WINDOW
    bad_height = min(40, n_win)
    t0 = time.perf_counter()
    entries, tampered = signed_window(
        host, types, vset, by_addr, chain_id, n_win, bad_height, rng
    )
    sign_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _, _, c in entries:
        vset._gather_items(chain_id, c, True)
    assembly_s = time.perf_counter() - t0
    n_sigs = n_win * args.validators
    os.environ.pop("TM_TPU_MXU_GATHER", None)
    v_host = bv.BatchVerifier(shape_registry=ShapeRegistry())
    v_dev = bv.BatchVerifier(device_challenge_min=2048, shape_registry=ShapeRegistry())
    os.environ["TM_TPU_MXU_GATHER"] = "1"
    v_mxu = bv.BatchVerifier(shape_registry=ShapeRegistry())
    del os.environ["TM_TPU_MXU_GATHER"]
    assert v_mxu._big_verify is eb.verify_prehashed_bigcache_mxu
    bulk = {}
    for label, bverifier, reps, tier, path_kernels in (
        ("host_hash", v_host, 2, "big",
         ("neg_pubkey_bigtable", "verify_prehashed_bigcache")),
        ("device_hash", v_dev, 2, "big_msgs",
         ("challenge_batch", "verify_prehashed_bigcache")),
        ("mxu_gather", v_mxu, 1, "big", ("verify_prehashed_bigcache_mxu",)),
    ):
        if bverifier is not v_host:
            bverifier._big = v_host._big  # the window's tables, built once
        ops.reset_launches()
        verdicts, walls, gcs, bitmap, items, ledger = run_window(
            bverifier, vset, chain_id, entries, reps, label
        )
        torch.cuda.synchronize()
        counts = ops.kernel_launches()
        for name in path_kernels:
            assert counts[name] > 0, f"{name} was not launched on the {label} path"
            launches[name] = launches.get(name, 0) + counts[name]
        check_window(host, verdicts, bitmap, items, ledger, n_win, bad_height,
                     tampered, args.validators, rng, label)
        b = bverifier._registry.bucket_for(n_sigs)
        assert all(e["dispatched"] == b for e in ledger), ledger
        tiers = bverifier._registry.buckets_by_tier()
        assert tiers[tier] == (b,), tiers
        bulk[label] = {"walls": walls, "gcs": gcs, "ledger": ledger, "tiers": tiers,
                       "launches": {k: v for k, v in counts.items() if v},
                       "verdicts": verdicts, "bitmap": bitmap}
        print(f"main path: bulk {label}: {n_win} commits x {args.validators} "
              f"validators = {n_sigs} rows, bucket {b}, tiers "
              f"{json.dumps({k: list(v) for k, v in tiers.items()})}; verdicts "
              f"[True]*{bad_height - 1} + [False] + [True]*{n_win - bad_height} "
              f"x{reps}; bitmap False on exactly the {len(tampered)} tampered "
              f"rows; 256-row sample = host oracle; launches "
              f"{json.dumps(bulk[label]['launches'])}")

    lap("3 main paths")

    # --- 4. timings ---------------------------------------------------------
    rows_store = verifier._small.tables.shape[0]
    active_table = int(
        (s_ok & (idx_t >= 0) & tvalid[idx_t.clamp(min=0).long()]).sum()
    )
    # the generic rows carry the same keys and s as the table rows
    active_generic = active_table
    n_keys = pub_d.shape[0]

    # the bulk window's operands at the main path's shapes
    win_items = [
        it for _, _, c in entries for it in vset._gather_items(chain_id, c, True)[0]
    ]
    big_store = v_host._big
    b_win = v_host._registry.bucket_for(n_sigs)
    w_idx = np.full(b_win, -1, dtype=np.int32)
    w_r = np.zeros((b_win, 32), dtype=np.uint8)
    w_s = np.zeros((b_win, 32), dtype=np.uint8)
    w_k = np.zeros((b_win, 32), dtype=np.uint8)
    w_ok = np.zeros(b_win, dtype=bool)
    t0 = time.perf_counter()
    for it in win_items:
        int.from_bytes(hashlib.sha512(it.sig[:32] + it.pubkey + it.msg).digest(),
                       "little") % host.L
    host_hash_ms = (time.perf_counter() - t0) * 1e3
    for i, it in enumerate(win_items):
        w_idx[i] = big_store._idx[it.pubkey]
        w_r[i] = np.frombuffer(it.sig[:32], np.uint8)
        w_s[i] = np.frombuffer(it.sig[32:], np.uint8)
        w_k[i] = np.frombuffer(
            host.challenge(it.sig[:32], it.pubkey, it.msg).to_bytes(32, "little"),
            np.uint8)
        w_ok[i] = int.from_bytes(it.sig[32:], "little") < host.L
    msgs = [it.msg for it in win_items] + [b""] * (b_win - n_sigs)
    prefixes = [it.sig[:32] + it.pubkey for it in win_items] + [b""] * (b_win - n_sigs)
    w_buf, w_cnt = sha512.pad_messages(msgs, prefix_pairs=prefixes)
    D = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    w_args = (big_store.tables, big_store.valid, D(w_idx), D(w_r), D(w_s),
              D(w_k), D(w_ok))
    w_buf_d, w_cnt_d = D(w_buf), D(w_cnt)
    # kernel 8's hash at the window's shape: equal to its plain version and
    # to the host challenges of the live rows
    got = sha512.challenge_batch(w_buf_d, w_cnt_d)
    got_plain = sha512.challenge_batch_plain(w_buf_d, w_cnt_d)
    torch.cuda.synchronize()
    err = max_abs_err(got, got_plain)
    errs["challenge_batch"] = max(errs["challenge_batch"], err)
    assert err == 0, f"challenge_batch: kernel != plain at the window's {b_win} rows"
    assert torch.equal(got[:n_sigs].cpu(), torch.from_numpy(w_k[:n_sigs])), (
        "challenge_batch != the host challenges at the window's rows")
    print(f"kernel-vs-plain: challenge_batch at the window's {b_win} rows ({n_sigs} "
          f"live, {int(w_cnt.sum())} blocks): equal to its plain version and the host "
          f"challenges (tolerance: exact)")
    live_big = int((w_ok & (w_idx >= 0)).sum())  # every window key is valid
    # kernel 6 (four lanes a row) at the window's shape too, the tampered
    # commit's rows included: equal to its plain version and the bitmap
    for name, kern, plain in (
        ("verify_prehashed_bigcache", eb.verify_prehashed_bigcache,
         eb.verify_prehashed_bigcache_plain),
        ("verify_prehashed_bigcache_mxu", eb.verify_prehashed_bigcache_mxu,
         eb.verify_prehashed_bigcache_mxu_plain),
    ):
        got = kern(*w_args)
        got_plain = plain(*w_args)
        torch.cuda.synchronize()
        err = max_abs_err(got, got_plain)
        errs[name] = max(errs[name], err)
        assert err == 0, f"{name}: kernel != plain at the window's {b_win} rows"
        got = got.cpu().tolist()
        assert got[:n_sigs] == bulk["host_hash"]["bitmap"] and not any(got[n_sigs:]), name
    print(f"kernel-vs-plain: verify_prehashed_bigcache and _mxu (four lanes a "
          f"row) at the window's {b_win} rows ({n_sigs} live, commit "
          f"{bad_height} tampered): equal to the plain versions and the "
          f"window's bitmap (tolerance: exact)")
    used_keys = len(big_store._idx)
    # the table build at the path's shape: 150 keys padded to the bucket
    n_build = v_host._registry.bucket_for(len(vset.validators))
    build_pubs = np.zeros((n_build, 32), dtype=np.uint8)
    for i, v in enumerate(vset.validators):
        build_pubs[i] = np.frombuffer(v.pub_key.data, np.uint8)
    build_d = D(build_pubs)
    blocks = int(w_cnt.sum())
    base_bytes = curve.base_table_bytes().size
    verify_big_bytes = (used_keys * 64 * 16 * 128 + used_keys + base_bytes + 96
                        + b_win * (4 + 3 * 32 + 1 + 1))
    work = {
        "neg_pubkey_table": (
            lambda: eb.neg_pubkey_table(pub_d),
            lambda: eb.neg_pubkey_table_plain(pub_d),
            n_keys * (32 + 16 * 128 + 1),
            n_keys * (FE_DECOMPRESS + FE_TABLE_BUILD) * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:51", SOURCE,
        ),
        "verify_prehashed_table": (
            lambda: eb.verify_prehashed_table(tables, tvalid, idx_t, R, S, K, s_ok),
            lambda: eb.verify_prehashed_table_plain(tables, tvalid, idx_t, R, S, K, s_ok),
            tables.numel() + tvalid.numel() + 4 * n_rows + 3 * 32 * n_rows
            + 2 * n_rows + base_bytes + 96,
            active_table * FE_VERIFY_TABLE * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:65", SOURCE,
        ),
        "verify_prehashed": (
            lambda: eb.verify_prehashed(G_pub, R, S, K, s_ok),
            lambda: eb.verify_prehashed_plain(G_pub, R, S, K, s_ok),
            4 * 32 * n_rows + 2 * n_rows + base_bytes + 96,
            (int(s_ok.sum()) * FE_DECOMPRESS
             + active_generic * (FE_TABLE_BUILD + FE_VERIFY_TABLE)) * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:36", SOURCE,
        ),
        "dbl_chain": (
            lambda: dc.dbl_chain(pts, n_dbl),
            lambda: dc.dbl_chain_plain(pts, n_dbl),
            2 * pts.numel(),
            n_pts * n_dbl * DBL_OPS,
            "tools/microbench_pallas.py:106", SOURCE,
        ),
        "neg_pubkey_bigtable": (
            lambda: eb.neg_pubkey_bigtable(build_d),
            lambda: eb.neg_pubkey_bigtable_plain(build_d),
            n_build * (32 + 64 * 16 * 128 + 1),
            n_build * FE_BIGTABLE * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:80", SOURCE,
        ),
        "verify_prehashed_bigcache": (
            lambda: eb.verify_prehashed_bigcache(*w_args),
            lambda: eb.verify_prehashed_bigcache_plain(*w_args),
            verify_big_bytes,
            live_big * FE_VERIFY_BIG * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:96", SOURCE,
        ),
        "verify_prehashed_bigcache_mxu": (
            lambda: eb.verify_prehashed_bigcache_mxu(*w_args),
            lambda: eb.verify_prehashed_bigcache_mxu_plain(*w_args),
            verify_big_bytes,
            live_big * FE_VERIFY_BIG * IMAD_PER_FE_MUL,
            "tendermint_tpu/ops/ed25519_batch.py:115", SOURCE,
        ),
        "challenge_batch": (
            lambda: sha512.challenge_batch(w_buf_d, w_cnt_d),
            lambda: sha512.challenge_batch_plain(w_buf_d, w_cnt_d),
            w_buf.size + 4 * b_win + 32 * b_win,
            blocks * SHA512_OPS_PER_BLOCK + b_win * SC_REDUCE_OPS,
            "tendermint_tpu/ops/sha512.py:394", SHA_SOURCE,
        ),
    }
    rows = []
    for name, (kern, plain, nbytes, n_ops, replaces, source) in work.items():
        ms = time_cuda(torch, kern, 20)
        plain_ms = time_cuda(torch, plain, 3)
        b_ms, b_by = bound_ms(nbytes, n_ops)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        print(f"time: {name} kernel {ms:.4f} ms plain {plain_ms:.2f} ms "
              f"bound {b_ms:.5f} ms ({b_by}) | {smi}")
    k3_ms = {}
    for b in KERNEL3_BUCKETS:
        k3_b = (tables, tvalid) + tuple(t[:b] for t in (idx_t, R, S, K, s_ok))
        k3_ms[b] = time_cuda(torch, lambda: eb.verify_prehashed_table(*k3_b), 20)
    print(f"kernel3: verify_table_kernel, four lanes a row, median ms of 20 "
          f"launches at buckets {json.dumps(k3_ms)} (the first b of the 256 "
          f"mixed rows); critical path {FE_VERIFY_TABLE_PATH} dependent field "
          f"multiplications a row (one thread a row: {FE_VERIFY_TABLE}); "
          f"checked at b = {[b for b, _ in KERNEL3_SIZES]}; ptxas: "
          f"{usages.get('verify_table_kernel', 'not reported')} | {smi}")
    k4_ms = {}
    for b in KERNEL3_BUCKETS:
        k4_b = tuple(t[:b] for t in (G_pub, R, S, K, s_ok))
        k4_ms[b] = time_cuda(torch, lambda: eb.verify_prehashed(*k4_b), 20)
    print(f"kernel4: verify_generic_kernel, four lanes a row, median ms of 20 "
          f"launches at buckets {json.dumps(k4_ms)} (the first b of the 256 "
          f"mixed rows); critical path {FE_VERIFY_GENERIC_PATH} dependent field "
          f"multiplications a row (one thread a row: {FE_VERIFY_GENERIC}); "
          f"checked at b = {[b for b, _ in KERNEL3_SIZES]}; ptxas: "
          f"{usages.get('verify_generic_kernel', 'not reported')} | {smi}")
    k6_2048 = time_cuda(torch, lambda: eb.verify_prehashed_bigcache(*big_args), 20)
    k6_win = next(r["ms"] for r in rows if r["name"] == "verify_prehashed_bigcache")
    print(f"kernel6: verify_bigcache_kernel, four lanes a row, median ms of 20 "
          f"launches at {len(big_idx)} mixed rows {k6_2048:.4f} and the window's "
          f"{b_win} rows ({live_big} live) {k6_win:.4f}; critical path "
          f"{FE_VERIFY_BIG_PATH} dependent field multiplications a row (one "
          f"thread a row: {FE_VERIFY_BIG}); checked at {len(big_idx)} and "
          f"{b_win} rows; ptxas: "
          f"{usages.get('verify_bigcache_kernel', 'not reported')} | {smi}")
    k2_ms = {n: time_cuda(torch, lambda: eb.neg_pubkey_table(pk), 20)
             for n, (pk, _) in k2_sets.items()}
    print(f"kernel2: neg_pubkey_table_kernel, four lanes a key, median ms of 20 "
          f"launches at keys {json.dumps(k2_ms)} (adversarial keys included); "
          f"critical path {FE_TABLE_PATH} dependent field multiplications a key "
          f"(one thread a key: {FE_DECOMPRESS + FE_TABLE_BUILD}); ptxas: "
          f"{usages.get('neg_pubkey_table_kernel', 'not reported')} | {smi}")
    k8_ms = {n: time_cuda(torch, lambda: sha512.challenge_batch(
        ch_buf_d[:n], ch_cnt_d[:n]), 20) for n in (len(ch_rows), KERNEL8_PARTIAL)}
    k8_ms[b_win] = next(r["ms"] for r in rows if r["name"] == "challenge_batch")
    print(f"kernel8: challenge_kernel, a lane a row, each warp staging its rows' "
          f"blocks in shared memory, median ms of 20 launches at rows "
          f"{json.dumps(k8_ms)} (the ragged rows, their first {KERNEL8_PARTIAL}, the "
          f"window's {blocks} blocks); ptxas: "
          f"{usages.get('challenge_kernel', 'not reported')} | {smi}")
    k1_ms = {n: time_cuda(torch, lambda: dc.dbl_chain(pts[:n], n_dbl), 20)
             for n in (1, KERNEL1_PARTIAL)}
    k1_ms[n_pts] = next(r["ms"] for r in rows if r["name"] == "dbl_chain")
    print(f"kernel1: dbl_chain_kernel, four lanes a point, median ms of 20 launches "
          f"at points {json.dumps(k1_ms)} x {n_dbl} doublings; critical path "
          f"{n_dbl * FE_DBL_PATH} dependent field multiplications a point (one thread "
          f"a point: {n_dbl * FE_DBL}); checked at {n_pts} and {KERNEL1_PARTIAL} "
          f"points; ptxas: {usages.get('dbl_chain_kernel', 'not reported')} | {smi}")
    k5_256 = time_cuda(torch, lambda: eb.neg_pubkey_bigtable(pub_d), 20)
    k5_win = next(r["ms"] for r in rows if r["name"] == "neg_pubkey_bigtable")
    print(f"kernel5: neg_pubkey_bigtable_kernel, four lanes a key and column, "
          f"median ms of 20 launches at {n_keys} keys (adversarial included) "
          f"{k5_256:.4f} and the window's build ({len(vset.validators)} keys in "
          f"the {n_build} bucket) {k5_win:.4f}; critical path {FE_BIGTABLE_PATH} "
          f"dependent field multiplications a thread (one thread a key and "
          f"column: {FE_BIGTABLE_THREAD}); checked at {n_keys} keys; ptxas: "
          f"{usages.get('neg_pubkey_bigtable_kernel', 'not reported')} | {smi}")
    print(f"time: verify_commit {args.validators} validators ms per height "
          f"{[round(x, 3) for x in commit_ms]} (first includes the table "
          f"build, store rows {rows_store}; with the one-thread kernel 3 "
          f"{COMMIT_MS_ONE_THREAD[0]}-{COMMIT_MS_ONE_THREAD[1]} ms after the "
          f"first, NVIDIA H100 80GB HBM3, 700 W) | {smi}")
    print(f"time: host hashlib + % L over the window's {n_sigs} rows "
          f"{host_hash_ms:.2f} ms (one CPU thread; tm_challenge at the same "
          f"rows is the challenge_batch line) | {smi}")
    print(f"time: bulk window signing {sign_s:.1f} s (host, set-up); sign-bytes "
          f"assembly of the window alone, first call {assembly_s * 1e3:.2f} ms")
    for label, rec in bulk.items():
        for rep, (wall, gc_s, e) in enumerate(
            zip(rec["walls"], rec["gcs"], rec["ledger"])
        ):
            # the ledger's queue wait runs from the submission to the
            # dispatch, so it holds the prepare; what lies outside the
            # round is verify_commits_light's own work: sign-bytes assembly,
            # the tally, and the thread hand-offs into the scheduler
            outside_s = wall - e["queue_wait_s"] - e["device_s"]
            host_s = outside_s + e["host_prep_s"]
            print(f"time: bulk {label} window {rep + 1}: wall {wall * 1e3:.2f} ms, "
                  f"{n_win / wall:.1f} commits/s; outside the round (sign-bytes "
                  f"assembly, tally) {outside_s * 1e3:.2f} ms + prepare "
                  f"{e['host_prep_s'] * 1e3:.2f} ms = host share "
                  f"{host_s / wall:.3f}; device round {e['device_s'] * 1e3:.2f} ms "
                  f"= device share {e['device_s'] / wall:.3f}; scheduler hand-off "
                  f"{(e['queue_wait_s'] - e['host_prep_s']) * 1e3:.2f} ms; gc pauses "
                  f"{gc_s * 1e3:.2f} ms | {smi}")

    lap("4 timings")

    # --- 5. the quorum-certificate path -------------------------------------
    qc_rows, point_sets, k12 = qc_phase(torch, rng, dev, smi, ops, types, vset,
                                        chain_id, entries)
    rows += qc_rows
    print(f"kernel12: tm_miller (miller_kernel, one warp a 2-pair chunk, then "
          f"chunk_product_kernel), median ms of 20 launches at the 2-pair verify "
          f"shape {k12['miller_verify']:.4f} and the 65-pair RLC shape "
          f"{k12['miller_rlc']:.4f}; tm_final_exp (final_exp_kernel, one warp an "
          f"element) {k12['final_exp']:.4f}; critical paths {FP_MILLER_PATH} (+1 a "
          f"chunk-product level; one thread: {FP_MILLER_THREAD}) and "
          f"{FP_FINAL_EXP_PATH} (one thread: {FP_FINAL_EXP}) dependent Fp "
          f"multiplications; ptxas: " + "; ".join(
              f"{k}: {usages.get(k, 'not reported')}"
              for k in ("miller_kernel", "chunk_product_kernel", "final_exp_kernel"))
          + f" | {smi}")

    lap("5 qc")

    # --- 6. the mixed-key path and the L2 block's merkle leaves ----------
    mix_rows, secp_arrays, k10, k9 = mixed_phase(torch, np, rng, dev, smi, ops, types,
                                                   vkeys, chain_id, args.heights)
    rows += mix_rows
    print(f"kernel9: sha256_kernel, a lane a row, each warp staging its rows' blocks "
          f"in shared memory, median ms of 20 launches {json.dumps(k9)}; critical path "
          f"the longest row's blocks x {SHA256_ROUND_PATH} dependent instructions a "
          f"round; ptxas: {usages.get('sha256_kernel', 'not reported')} | {smi}")
    print(f"kernel10: secp_verify_kernel, a group of {SECP_ROW_LANES} lanes a row, median "
          f"ms of 20 launches at the window's {k10['rows']} rows ({k10['live']} live) "
          f"{k10['ms']:.4f} and a mesh shard's {SECP_SHARD_ROWS} rows "
          f"({k10['shard_live']} live) {k10['shard_ms']:.4f}; critical path "
          f"{k10['lane_path']:.1f} dependent product stages a row (one thread a row: "
          f"{k10['thread_path']:.1f} dependent field multiplications; means over the "
          f"window's live rows); ptxas: "
          f"{usages.get('secp_verify_kernel', 'not reported')} | {smi}")

    lap("6 mixed")

    # --- 7. the in-process consensus net -------------------------------------
    net, net_errs = consensus_phase(torch, ops, host, smi, args.seed,
                                    NET_VALIDATORS, NET_HEIGHTS)
    for row in rows:
        row["launches"] += net.get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"], net_errs.get(row["name"], 0))
    print(f"main path: consensus net launches per kernel, the three modes "
          f"{json.dumps({k: v for k, v in net.items() if v})} (added to the "
          f"kernels line's launches)")

    lap("7 consensus net")

    # --- 8. the multi-device path -------------------------------------------
    mesh_rows, mesh_launches, sharded_ms = mesh_phase(
        torch, np, rng, dev, smi, ops, host, vset, chain_id, entries, tampered,
        bad_height, bulk, g_items, point_sets, secp_arrays)
    for row in rows:
        row["launches"] += mesh_launches.get(row["name"], 0)
    rows += mesh_rows
    for name in ("neg_pubkey_table", "verify_prehashed_table", "verify_prehashed",
                 "neg_pubkey_bigtable", "verify_prehashed_bigcache",
                 "verify_prehashed_bigcache_mxu", "challenge_batch",
                 "secp_verify_prehashed", "g1_aggregate", "g2_aggregate",
                 "g1_add", "g2_add"):
        assert mesh_launches.get(name, 0) > 0, f"{name} was not launched on the mesh path"
    print(f"main path: mesh path launches per kernel "
          f"{json.dumps({k: v for k, v in mesh_launches.items() if v})} (added to "
          f"the kernels line's launches)")
    g2_add_ms = next(r["ms"] for r in mesh_rows if r["name"] == "g2_add")
    one, warp = g2_tree_paths(args.validators)
    print(f"g2sums: g2_aggregate_kernel (a warp an addition, at most "
          f"{G2_TREE_WARPS} warps a tree), median ms of 20 launches at (1, "
          f"{args.validators}) {k12['g2_aggregate']:.4f} and the ({WINDOW}, "
          f"{args.validators}) forest {k12['g2_forest']:.4f}; g2_add_kernel (a warp a "
          f"pair) at 1 pair {g2_add_ms:.4f}; g2_aggregate_sharded over {MESH_SHARDS} "
          f"shards {sharded_ms['g2']:.4f}; critical paths in dependent Fp "
          f"multiplications: the tree of {args.validators} keys {warp} (one thread an "
          f"addition: {one}), g2_add {FP_G2_ADD_KERNEL_PATH} (one thread: "
          f"{FP_G2_ADD_THREAD}), an addition {FP_G2_ADD_PATH} (one thread: "
          f"{FP_G2_ADD}), a doubling {FP_G2_DBL_PATH}; ptxas: " + "; ".join(
              f"{k}: {usages.get(k, 'not reported')}"
              for k in ("g2_aggregate_kernel", "g2_add_kernel")) + f" | {smi}")
    g1_add_ms = next(r["ms"] for r in mesh_rows if r["name"] == "g1_add")
    one, group = g1_tree_paths(args.validators)
    print(f"g1sums: g1_aggregate_kernel (a group of {G1_TREE_LANES} lanes an addition, "
          f"{32 // G1_TREE_LANES} groups a warp, at most {G1_TREE_WARPS} warps a tree), "
          f"median ms of 20 launches at (1, {args.validators}) {k12['g1_aggregate']:.4f} "
          f"and the ({WINDOW}, {args.validators}) forest {k12['g1_forest']:.4f}; "
          f"g1_add_kernel (a group of {G1_ADD_LANES} lanes a pair) at 1 pair "
          f"{g1_add_ms:.4f}; "
          f"g1_aggregate_sharded over {MESH_SHARDS} shards {sharded_ms['g1']:.4f}; "
          f"critical paths in dependent Fp multiplications: the tree of "
          f"{args.validators} signatures {group} (one thread an addition: {one}), "
          f"g1_add {FP_G1_ADD_KERNEL_PATH} (one thread: {FP_G1_ADD_THREAD}), an "
          f"addition {FP_G1_ADD_PATH} (one thread: {FP_G1_ADD}), a doubling "
          f"{FP_G1_DBL_PATH}; ptxas: " + "; ".join(
              f"{k}: {usages.get(k, 'not reported')}"
              for k in ("g1_aggregate_kernel", "g1_add_kernel")) + f" | {smi}")

    lap("8 multi-device")

    # --- 9. the catch-up path ----------------------------------------------
    catchup, catchup_errs, catchup_src, catchup_walls = catchup_phase(
        torch, ops, host, smi, rng, vkeys, powers, chain_id, bulk["host_hash"]["walls"])
    for row in rows:
        row["launches"] += catchup.get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"], catchup_errs.get(row["name"], 0))
    print(f"main path: catch-up launches per kernel, the three modes "
          f"{json.dumps({k: v for k, v in catchup.items() if v})} (added to the "
          f"kernels line's launches)")

    lap("9 catch-up")

    # --- 10. the bulk rest and the chaos mesh -------------------------------
    t0 = time.perf_counter()
    rest, rest_errs = bulk_rest_phase(torch, ops, host, smi, rng, catchup_src, vkeys)
    for row in rows:
        row["launches"] += rest.get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"], rest_errs.get(row["name"], 0))
    print(f"main path: bulk rest launches per kernel, the four parts "
          f"{json.dumps({k: v for k, v in rest.items() if v})} (added to the kernels "
          f"line's launches); phase 10 took {time.perf_counter() - t0:.1f} s | {smi}")

    lap("10 bulk rest")

    # --- 11. the verify service and the sequencer plane ---------------------
    t0 = time.perf_counter()
    svc_launches, service_errs = service_phase(torch, ops, host, smi, rng, vset, chain_id,
                                          commits[: args.heights], catchup_src)
    for row in rows:
        row["launches"] += svc_launches.get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"], service_errs.get(row["name"], 0))
    print(f"main path: verify service launches per kernel, the three parts "
          f"{json.dumps({k: v for k, v in svc_launches.items() if v})} (added to the kernels "
          f"line's launches); phase 11 took {time.perf_counter() - t0:.1f} s | {smi}")

    lap("11 verify service")

    # --- 12. the event plane: a joining node's events, index and socket app -
    # --- 13. the operator plane: that node profiled over its RPC, a proxy --
    t0 = time.perf_counter()
    ev_launches, events_errs, (op_launches, op_errs, op_wall) = events_phase(
        torch, ops, host, smi, rng, catchup_src, catchup_walls["a"],
        operator=lambda node: operator_phase(torch, ops, host, smi, rng, node,
                                             catchup_walls["c_step"]))
    for row in rows:
        for got, errs in ((ev_launches, events_errs), (op_launches, op_errs)):
            row["launches"] += got.get(row["name"], 0)
            row["max_abs_err"] = max(row["max_abs_err"], errs.get(row["name"], 0))
    print(f"main path: event plane launches per kernel "
          f"{json.dumps({k: v for k, v in ev_launches.items() if v})}, operator plane "
          f"{json.dumps({k: v for k, v in op_launches.items() if v})} (added to the kernels "
          f"line's launches); phases 12 and 13 took {time.perf_counter() - t0:.1f} s, phase 13 "
          f"{op_wall:.1f} s of it | {smi}")

    lap("12 event plane")
    phase_walls["12 event plane"] = round(phase_walls["12 event plane"] - op_wall, 1)
    phase_walls["13 operator plane"] = round(op_wall, 1)

    # --- 14. the assembled node: a CLI-started node, a CLI testnet ----------
    t0 = time.perf_counter()
    node_launches = node_phase(smi, catchup_src, catchup_walls["a"])
    del catchup_src
    testnet_phase(smi)
    for row in rows:
        row["node_launches"] = node_launches.get(row["name"], 0)
        row["launches"] += row["node_launches"]
    print(f"main path: assembled node launches per kernel (the CLI-started child's, from its "
          f"/debug/torch/launches) {json.dumps({k: v for k, v in node_launches.items() if v})} "
          f"(added to the kernels line's launches, and each row's node_launches); phase 14 took "
          f"{time.perf_counter() - t0:.1f} s | {smi}")

    lap("14 assembled node")

    # --- 15. the harnesses: the port's tools at their own sizes -------------
    harness_launches = harness_phase(torch, ops, smi)
    for row in rows:
        row["harness_launches"] = harness_launches.get(row["name"], 0)
        row["launches"] += row["harness_launches"]
    print(f"main path: harnesses launches per kernel, (b) and (c) in this process "
          f"{json.dumps({k: v for k, v in harness_launches.items() if v})} (added to the kernels "
          f"line's launches, and each row's harness_launches) | {smi}")

    lap("15 harnesses")

    # --- result lines -------------------------------------------------------
    kernels_line = json.dumps({"kernels": rows})
    last = json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    whole = sum(phase_walls.values())
    print(f"time: smoke walls per phase (s) {json.dumps(phase_walls)}; whole {whole:.1f} s, "
          f"against the chip tool's limit of {SMOKE_LIMIT_S} s | {smi}")
    print(kernels_line)
    print(smi)
    print(last)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:
        # a failing phase may leave a worker thread blocked on a stopped
        # event loop: report and exit now rather than join it
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.exit(rc)
