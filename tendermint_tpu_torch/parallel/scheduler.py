"""Unified verification dispatch scheduler — one process-wide async
service every device-verify caller submits signature work to.

PERF_ANALYSIS §10: after the math was fast, the remaining losses were
dispatch plumbing — churn throughput floor-bound at 21 *sequential*
~110 ms single-batch dispatches with the host idle during each device
round, and a cold bisect-1k spending ~206 s loading 44 distinct
op-shape programs. Both are per-caller problems: the vote MicroBatcher,
blocksync commit replay, light bisection and evidence checks each owned
a private path to `BatchVerifier` and dispatched whatever ad-hoc batch
they happened to hold. This scheduler replaces those private paths:

- **shape-bucketed programs**: every dispatch pads to the canonical
  ladder owned by crypto/shape_registry, so the whole node executes
  from a handful of precompiled programs per tier (prewarmable at
  assembly via `BatchVerifier.prewarm_buckets` / tools/prewarm.py);
- **cross-subsystem coalescing with priority**: items from different
  submitters merge into ONE padded device batch per round. Classes are
  served in fixed priority order (consensus votes preempt the bulk
  backfill families) while per-submitter FIFO is preserved — a
  submission's verdicts resolve in the order its class queue received
  them, and rounds complete strictly in dispatch order;
- **pipelined host/device overlap**: while batch N executes on the
  dispatch thread, batch N+1 is assembled, padded and sign-bytes
  challenge-hashed on the prep thread (`BatchVerifier.prepare` /
  `_PreparedBatch.run` split) — the host no longer idles through each
  ~110 ms device round;
- **mesh-sharded rounds**: when the verifier carries a device mesh
  ([scheduler] mesh_enable / [tpu] axes), a coalesced round of at
  least `mesh_min_rows` rows is padded to a bucket divisible by the
  device count and row-sharded across every chip as ONE dispatch —
  the round's verdict gather rides ICI, and the `scheduler.device_round`
  span carries `sharded`/`devices` so the flight recorder attributes
  multi-chip rounds. Small rounds stay effectively single-device for
  latency (BatchVerifier.shards_for decides).

Callers reach it through `default_dispatch(klass)`, which returns a
classed adapter with the BatchVerifier.verify surface when a scheduler
is installed and falls back to the shared verifier otherwise — so the
same call sites work in tests, bench isolation, and full nodes. The
adapter also degrades to direct dispatch when invoked ON an event-loop
thread (blocking there would deadlock the service); executor-thread
callers (blocksync windowed verify, the vote micro-batcher's verify
thread, light bisection) get the full coalescing path.

Reference counterpart: none — the reference verifies serially inside
each subsystem (consensus/state.go:2274, blocksync/reactor.go:553,
light/verifier.go:58). The committee-BFT batched-verification papers
(PAPERS.md) make the case for amortizing fixed costs across callers;
this is that amortization for the dispatch floor itself.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ..crypto.batch_verifier import SigItem, default_verifier
from ..crypto.shape_registry import default_shape_registry
from ..libs.log import Logger, nop_logger
from ..libs.metrics import SchedulerMetrics, default_metrics
from ..obs import default_tracer
from ..obs.ledger import DispatchLedger, default_ledger

# Priority classes, served strictly in this order when assembling a
# round: live consensus votes must never queue behind a blocksync/light
# backfill flood, and serving EXTERNAL light clients (the lightserve
# plane's shared bisection verifies) ranks below even the node's own
# light-client work. `sequencer` — the post-upgrade BlockV2 stream's
# ECDSA recover rounds (fn lane) — sits directly under consensus: after
# the switch it IS the live chain, and pre-switch it carries no load,
# so it never competes with live votes. Starvation the other way is
# structurally bounded — every round takes whatever capacity the higher
# classes left (consensus load is O(validators) per height, max_batch
# is 16k).
CLASS_ORDER = (
    "consensus", "sequencer", "evidence", "blocksync", "light", "lightserve"
)

DEFAULT_MAX_BATCH = 16384

# sentinel returned to submit_sync/submit_fn_sync when the scheduler
# stopped between the caller's `running` check and the coroutine
# actually executing on the loop: the CALLING worker thread then runs
# the work itself. Degrading through the shared default executor here
# (what submit/submit_fn do for direct callers) can deadlock — the
# calling thread already HOLDS a default-executor slot, and on a small
# pool (min(32, cpus+4); 6 on a 2-core box) every slot can be held by
# threads waiting on exactly this degrade, so the queued fallback never
# gets a slot.
_NOT_RUNNING = object()


class _Submission:
    """One caller's unit of work. Large submissions may be consumed
    across several rounds (offset/remaining); verdicts accumulate into
    one aligned array and the future resolves when the last slice's
    round completes."""

    __slots__ = (
        "items", "klass", "n", "fn", "engine", "verdicts", "remaining",
        "offset", "future", "t_enq", "failed", "ctx", "t_progress",
    )

    def __init__(self, items, klass, future, fn=None, engine="fn",
                 ctx=None):
        self.items = items
        self.klass = klass
        self.n = len(items)
        self.fn = fn  # non-None => private-engine lane (e.g. BLS groups)
        # accounting label for fn-lane rounds: "fn" for anonymous
        # closures, the wire-engine name (bls_agg / qc_verify /
        # secp_recover) when known — the ledger breaks rpd/fill out
        # per engine so one-submission fn rounds stop diluting the sig
        # plane's coalescing numbers
        self.engine = engine
        self.verdicts = (
            None if fn is not None else np.zeros(self.n, dtype=bool)
        )
        self.remaining = self.n
        self.offset = 0
        self.future = future
        self.t_enq = time.perf_counter()
        # trace context (height, round, origin, req) stamped by remote
        # clients over the UDS wire — the scheduler records this
        # submission's queue/device sub-spans under it so the caller's
        # per-height timeline can bill verify time across the process
        # split. None for untraced (in-proc) submissions. t_progress is
        # where this submission's NEXT queue span starts: enqueue time
        # for the first round, the previous round's completion after —
        # a multi-round submission must not re-bill earlier rounds'
        # device time as queue wait.
        self.ctx = ctx
        self.t_progress = self.t_enq
        # set when a round carrying one of this submission's slices
        # failed: the future already holds the exception, so any
        # not-yet-dispatched remainder is dead work and must be dropped
        # at the queue head instead of burning device rounds
        self.failed = False


class _ClassedVerifier:
    """BatchVerifier.verify-surface adapter bound to one priority class.

    Safe to hand anywhere a BatchVerifier is accepted (ValidatorSet
    commit verification, evidence checks): `verify()` routes through the
    scheduler from worker threads and degrades to the underlying
    verifier when the scheduler isn't running or the caller is on an
    event-loop thread."""

    __slots__ = ("_sched", "_klass")

    def __init__(self, sched: "VerifyScheduler", klass: str):
        self._sched = sched
        self._klass = klass

    def verify(self, items: list[SigItem]) -> np.ndarray:
        return self._sched.submit_sync(items, self._klass)

    def verify_one(self, pubkey: bytes, msg: bytes, sig: bytes) -> bool:
        return bool(self.verify([SigItem(pubkey, msg, sig)])[0])

    def warm(self, *args, **kwargs):
        return self._sched.verifier.warm(*args, **kwargs)

    @property
    def shutdown_event(self):
        return self._sched.verifier.shutdown_event


class VerifyScheduler:
    """The process-wide dispatch service. Lifecycle: construct anywhere,
    `await start()` on the serving loop (node assembly does this in
    on_start), `await stop()` to drain — queued submissions are still
    dispatched, then the worker exits. Until started (and after stop)
    every entry point degrades to direct dispatch on the wrapped
    verifier, so non-node harnesses never block."""

    def __init__(
        self,
        verifier=None,
        max_batch: int = DEFAULT_MAX_BATCH,
        logger: Optional[Logger] = None,
        metrics: Optional[SchedulerMetrics] = None,
        ledger: Optional[DispatchLedger] = None,
        dispatch_log_size: int = 1024,
        tracer=None,
    ):
        self.verifier = verifier or default_verifier()
        self.max_batch = max(1, int(max_batch))
        self.logger = logger or nop_logger()
        # is-None check: an empty Tracer is falsy (it has __len__); when
        # unset the process default is resolved AT RECORD TIME so a
        # later set_default_tracer still captures this scheduler
        self.tracer = tracer
        self.metrics = metrics or default_metrics(SchedulerMetrics)
        # device-cost ledger (obs/ledger.py): every round lands there
        # as a structured entry with per-class rows, fill, queue-wait/
        # host-prep/device-execute seconds. Process default unless a
        # test isolates with its own instance.
        self.ledger = ledger if ledger is not None else default_ledger()
        self._queues: dict[str, deque[_Submission]] = {
            k: deque() for k in CLASS_ORDER
        }
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wakeup: Optional[asyncio.Event] = None
        self._worker: Optional[asyncio.Task] = None
        self._accepting = False
        self._prep_pool: Optional[ThreadPoolExecutor] = None
        self._dispatch_pool: Optional[ThreadPoolExecutor] = None
        # telemetry for tests/debugging ONLY: recent rounds as
        # {n, subs, classes, fill} dicts, bounded at dispatch_log_size
        # ([scheduler] dispatch_log_size, default 1024) — entries past
        # the cap silently age out, so the LEDGER above, whose totals
        # never truncate, is the accounting source of truth (a reader
        # of its stats hits the 1024-cap of this ring)
        self.dispatch_log: deque = deque(
            maxlen=max(1, int(dispatch_log_size))
        )

    # --- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return (
            self._accepting
            and self._worker is not None
            and not self._worker.done()
        )

    async def start(self) -> None:
        if self.running:
            return
        self._loop = asyncio.get_running_loop()
        self._wakeup = asyncio.Event()
        # single-thread pools: prep and dispatch are each serial stages
        # of a two-deep pipeline; the overlap IS the design, more
        # threads would only fight over the one device
        self._prep_pool = ThreadPoolExecutor(
            1, thread_name_prefix="verify-prep"
        )
        self._dispatch_pool = ThreadPoolExecutor(
            1, thread_name_prefix="verify-dispatch"
        )
        self._accepting = True
        # static topology gauge: how many devices the verify plane
        # dispatches over (1 = meshless single-device)
        self.metrics.mesh_devices.set(
            getattr(self.verifier, "mesh_devices", 1)
        )
        self._worker = self._loop.create_task(self._run())

    async def stop(self) -> None:
        """Clean drain: stop accepting, dispatch everything queued,
        wait for the worker to exit."""
        self._accepting = False
        if self._wakeup is not None:
            self._wakeup.set()
        worker, self._worker = self._worker, None
        if worker is not None:
            try:
                await worker
            except asyncio.CancelledError:
                pass
        for pool in (self._prep_pool, self._dispatch_pool):
            if pool is not None:
                pool.shutdown(wait=False)
        self._prep_pool = self._dispatch_pool = None

    # --- submission --------------------------------------------------------

    async def submit(
        self, items: list[SigItem], klass: str = "consensus", ctx=None
    ) -> np.ndarray:
        """Queue items under `klass`; resolves to the aligned verdict
        bitmap. Must be awaited on the scheduler's own loop (cross-
        thread callers use submit_sync). `ctx` is an optional trace
        context (height, round, origin, req) — the verify-service
        passes the one its client stamped on the wire."""
        items = list(items)
        if not items:
            return np.zeros(0, dtype=bool)
        if not self.running:
            return await asyncio.get_running_loop().run_in_executor(
                None, self.verifier.verify, items
            )
        return await self._enqueue(items, klass, fn=None, ctx=ctx)

    async def submit_fn(
        self, items: list, fn: Callable[[list], list],
        klass: str = "consensus", engine: str = "fn", ctx=None,
    ):
        """Private-engine lane: `fn(items)` runs as its own round on the
        shared dispatch thread, under the same priority ordering — the
        BLS batch-point batcher rides this so pairing checks and ed25519
        rounds serialize instead of contending for the device. `engine`
        is the accounting label (wire-engine name when known)."""
        items = list(items)
        if not items:
            return []
        if not self.running:
            return await asyncio.get_running_loop().run_in_executor(
                None, fn, items
            )
        return await self._enqueue(
            items, klass, fn=fn, engine=engine, ctx=ctx
        )

    async def submit_wire_fn(
        self,
        engine: str,
        items: list,
        klass: str = "consensus",
        fallback: Optional[Callable[[], list]] = None,
    ):
        """Named-engine lane — the in-proc half of the wire-engine
        surface (RemoteVerifyScheduler ships the same call over the
        UDS): resolve `engine` from the shared table
        (parallel/engines.BUILTIN_ENGINES) and run it as a labeled fn
        round. Unknown engines run the caller's `fallback` instead."""
        from .engines import BUILTIN_ENGINES

        fn = BUILTIN_ENGINES.get(engine)
        if fn is None:
            fb = fallback or (lambda: [None] * len(items))
            return await asyncio.get_running_loop().run_in_executor(
                None, fb
            )
        return await self.submit_fn(items, fn, klass, engine=engine)

    def submit_wire_fn_sync(
        self,
        engine: str,
        items: list,
        klass: str = "consensus",
        fallback: Optional[Callable[[], list]] = None,
    ):
        """Blocking named-engine submit for worker threads — same
        degradation rules as submit_fn_sync, with unknown engines
        running `fallback` on the calling thread."""
        from .engines import BUILTIN_ENGINES

        items = list(items)
        fn = BUILTIN_ENGINES.get(engine)
        if fn is None:
            fb = fallback or (lambda: [None] * len(items))
            return fb()
        return self.submit_fn_sync(items, fn, klass, engine=engine)

    async def _enqueue(self, items, klass, fn, engine="fn", ctx=None):
        if klass not in self._queues:
            klass = "blocksync"  # unknown classes ride the bulk lane
        fut = self._loop.create_future()
        sub = _Submission(items, klass, fut, fn=fn, engine=engine, ctx=ctx)
        self._queues[klass].append(sub)
        self._wakeup.set()
        # gauge scope = submitted until verdicts resolve (in flight)
        with self.metrics.queue_depth.track_inprogress(sub.n, klass=klass):
            return await fut

    async def _submit_for_thread(self, items, klass):
        """submit() for run_coroutine_threadsafe bridges: when the
        scheduler stopped in the submit window, hand the work BACK to
        the calling thread (see _NOT_RUNNING) instead of queueing it on
        the shared default executor from here."""
        if not items:
            return np.zeros(0, dtype=bool)
        if not self.running:
            return _NOT_RUNNING
        return await self._enqueue(list(items), klass, fn=None)

    async def _submit_fn_for_thread(self, items, fn, klass, engine="fn"):
        if not items:
            return []
        if not self.running:
            return _NOT_RUNNING
        return await self._enqueue(list(items), klass, fn=fn, engine=engine)

    def submit_sync(
        self, items: list[SigItem], klass: str = "consensus"
    ) -> np.ndarray:
        """Blocking submit for worker threads (blocksync's windowed
        verify, the vote micro-batcher's executor thread). Degrades to
        direct dispatch ON THE CALLING THREAD when the scheduler isn't
        running, when called on an event-loop thread, or when the
        scheduled round fails."""
        items = list(items)
        loop = self._loop
        if not self.running or loop is None or self._on_loop_thread():
            return np.asarray(self.verifier.verify(items))
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self._submit_for_thread(items, klass), loop
            )
            res = fut.result()
            if res is _NOT_RUNNING:
                return np.asarray(self.verifier.verify(items))
            return np.asarray(res)
        except Exception as e:
            self.logger.error(
                "scheduled verify failed; direct dispatch", err=repr(e)
            )
            return np.asarray(self.verifier.verify(items))

    def submit_fn_sync(
        self, items: list, fn: Callable[[list], list],
        klass: str = "consensus", engine: str = "fn",
    ):
        items = list(items)
        loop = self._loop
        if not self.running or loop is None or self._on_loop_thread():
            return fn(items)
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self._submit_fn_for_thread(items, fn, klass, engine), loop
            )
            res = fut.result()
            if res is _NOT_RUNNING:
                return fn(items)
            return res
        except Exception as e:
            self.logger.error(
                "scheduled fn-lane verify failed; direct dispatch",
                err=repr(e),
            )
            return fn(items)

    @staticmethod
    def _on_loop_thread() -> bool:
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return False
        return True

    def classed(self, klass: str) -> _ClassedVerifier:
        """A BatchVerifier-shaped handle submitting under `klass`."""
        return _ClassedVerifier(self, klass)

    # --- the worker --------------------------------------------------------

    def _take_round(self):
        """Assemble one round from the class queues in priority order.
        Returns None (nothing ready), ("fn", submission), or
        ("sig", slices, total) where slices are (sub, lo, take) spans.
        Per-class FIFO: a class's head submission is never bypassed by a
        later one in the same class."""
        slices: list[tuple[_Submission, int, int]] = []
        total = 0
        for klass in CLASS_ORDER:
            q = self._queues[klass]
            while q and total < self.max_batch:
                sub = q[0]
                if sub.failed:
                    # an earlier slice's round failed: the caller already
                    # saw the exception — discard the remainder
                    q.popleft()
                    continue
                if sub.fn is not None:
                    if slices:
                        # dispatch the coalesced sig batch first; this
                        # fn round stays at its class head for the next
                        # turn (FIFO within the class is preserved)
                        break
                    q.popleft()
                    return ("fn", sub)
                take = min(sub.n - sub.offset, self.max_batch - total)
                lo = sub.offset
                sub.offset += take
                slices.append((sub, lo, take))
                total += take
                if sub.offset >= sub.n:
                    q.popleft()
                else:
                    break  # round is full mid-submission
        if not slices:
            return None
        return ("sig", slices, total)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        inflight: Optional[asyncio.Task] = None
        try:
            while True:
                round_ = self._take_round()
                if round_ is None:
                    if inflight is not None:
                        await inflight
                        inflight = None
                        continue
                    if not self._accepting:
                        break
                    self._wakeup.clear()
                    if any(self._queues[k] for k in CLASS_ORDER):
                        continue  # landed between take and clear
                    await self._wakeup.wait()
                    continue
                prep = await self._host_prep(loop, round_)
                if prep is None:
                    continue  # prep failed; futures already resolved
                run, devices, prep_s = prep
                # serialize device rounds: round N completes (and its
                # verdicts resolve) before round N+1 dispatches — while
                # N executes, the loop above already prepped N+1
                if inflight is not None:
                    await inflight
                    inflight = None
                inflight = loop.create_task(
                    self._execute(round_, run, devices, prep_s)
                )
        except asyncio.CancelledError:
            pass  # forced cancel (loop teardown): fall through to drain
        finally:
            if inflight is not None:
                try:
                    await inflight
                except (asyncio.CancelledError, Exception):
                    pass
            self._fail_pending(RuntimeError("verify scheduler stopped"))

    async def _host_prep(self, loop, round_):
        """Stage 1 of the pipeline: host-side batch assembly (padding,
        sign-bytes challenge hashing) on the prep thread. Returns
        (device-run callable, mesh device count of the dispatch,
        host-prep seconds), or None after resolving failures."""
        kind = round_[0]
        if kind == "fn":
            sub = round_[1]
            return (lambda: sub.fn(sub.items)), 1, 0.0
        _, slices, total = round_
        flat: list[SigItem] = []
        for sub, lo, take in slices:
            flat.extend(sub.items[lo : lo + take])
        prep_fn = getattr(self.verifier, "prepare", None)
        if prep_fn is None:
            # plain .verify-only verifier (test stubs): no split, the
            # whole call runs on the dispatch thread
            return (lambda: self.verifier.verify(flat)), 1, 0.0
        t0 = time.perf_counter()
        try:
            prepared = await loop.run_in_executor(
                self._prep_pool, prep_fn, flat
            )
        except Exception as e:
            self.logger.error("verify host prep failed", err=repr(e))
            self._fail_slices(slices, e)
            return None
        prep_s = time.perf_counter() - t0
        self._trace().add_span(
            "scheduler.host_prep",
            t0,
            prep_s,
            n=total,
        )
        return prepared.run, getattr(prepared, "devices", 1), prep_s

    def _trace(self):
        return self.tracer if self.tracer is not None else default_tracer()

    def _ctx_spans(self, tracer, sub, t0: float, dur: float, rows: int):
        """Per-submission queue/device sub-spans under the submission's
        wire trace context: the client's height/round land on the
        SERVICE's ring so the merged cluster timeline can bill a verify
        round trip's queue and device slices to the height that paid
        them (the in-proc scheduler.queue_wait/device_round spans carry
        no height and only bin correctly on the ring that also holds
        the height's step spans). Queue time starts at t_progress, not
        t_enq: a later round's wait must exclude the earlier rounds'
        device time (verify_flow SUMS these durations per request)."""
        height, round_, origin, req = sub.ctx
        wait = max(0.0, t0 - sub.t_progress)
        sub.t_progress = t0 + dur
        if wait > 0:
            tracer.add_span(
                "verify.queue", t0 - wait, wait,
                height=height, round=round_, origin=origin, req=req,
                n=rows, klass=sub.klass,
            )
        tracer.add_span(
            "verify.device", t0, dur,
            height=height, round=round_, origin=origin, req=req,
            n=rows, klass=sub.klass,
        )

    async def _execute(
        self, round_, run, devices: int = 1, prep_s: float = 0.0
    ) -> None:
        loop = asyncio.get_running_loop()
        kind = round_[0]
        tracer = self._trace()
        t0 = time.perf_counter()
        try:
            verdicts = await loop.run_in_executor(self._dispatch_pool, run)
        except Exception as e:
            self.logger.error("verify dispatch failed", err=repr(e))
            if kind == "sig":
                self._fail_slices(round_[1], e)
            else:
                sub = round_[1]
                if not sub.future.done():
                    sub.future.set_exception(e)
            return
        dur = time.perf_counter() - t0
        self.metrics.dispatches.inc()
        if devices > 1:
            self.metrics.dispatch_sharded.inc()
        if kind == "fn":
            sub = round_[1]
            if not sub.future.done():
                sub.future.set_result(verdicts)
            self.dispatch_log.append(
                {"n": sub.n, "subs": 1, "classes": [sub.klass],
                 "fn": True, "engine": sub.engine}
            )
            wait = t0 - sub.t_enq
            self.metrics.device_seconds.inc(dur, klass=sub.klass)
            # fn engines pad INTERNALLY (a 150-signer bls_agg group runs
            # one 256-bucket aggregate round); engines that expose their
            # true bucket via `internal_rows` book it honestly — on the
            # fn plane's own per-engine axis, never blended into the sig
            # plane's fill distribution
            internal = getattr(sub.fn, "internal_rows", None)
            try:
                dispatched = (
                    max(sub.n, int(internal(sub.items)))
                    if callable(internal) else sub.n
                )
            except Exception:
                dispatched = sub.n
            self.metrics.fn_fill_ratio.set(
                round(sub.n / dispatched, 4) if dispatched else 0.0,
                engine=sub.engine,
            )
            self.ledger.record_round(
                t0,
                class_rows={sub.klass: sub.n},
                requested=sub.n,
                dispatched=dispatched,
                submissions=1,
                queue_wait_s=wait,
                class_queue_wait={sub.klass: wait},
                device_s=dur,
                engine=sub.engine,
            )
            tracer.add_span(
                "scheduler.device_round", t0, dur,
                n=sub.n, engine=sub.engine, klass=sub.klass,
            )
            if sub.ctx is not None:
                self._ctx_spans(tracer, sub, t0, dur, sub.n)
            return
        _, slices, total = round_
        arr = np.asarray(verdicts)
        off = 0
        oldest = min(sub.t_enq for sub, _, _ in slices)
        for sub, lo, take in slices:
            sub.verdicts[lo : lo + take] = arr[off : off + take]
            off += take
            sub.remaining -= take
            if sub.remaining == 0 and not sub.future.done():
                self.metrics.queue_wait_seconds.observe(t0 - sub.t_enq)
                sub.future.set_result(sub.verdicts)
        n_subs = len({id(sub) for sub, _, _ in slices})
        classes = sorted({sub.klass for sub, _, _ in slices})
        registry = getattr(
            self.verifier, "_registry", None
        ) or default_shape_registry()
        bucket = registry.bucket_for(total, multiple_of=max(1, devices))
        fill = total / bucket if bucket else 0.0
        if n_subs >= 2:
            self.metrics.dispatch_coalesced.inc()
        self.metrics.batch_fill_ratio.set(round(fill, 4))
        # device-cost ledger + the tm_scheduler_* accounting surface:
        # rows/submissions/queue-wait per class, device time attributed
        # by row share, padding = the bucket rows bought and discarded
        class_rows: dict[str, int] = {}
        class_subs: dict[str, int] = {}
        class_wait: dict[str, float] = {}
        for sub, _, take in slices:
            class_rows[sub.klass] = class_rows.get(sub.klass, 0) + take
            class_subs[sub.klass] = class_subs.get(sub.klass, 0) + 1
            class_wait[sub.klass] = (
                class_wait.get(sub.klass, 0.0) + (t0 - sub.t_enq)
            )
        for klass, rows in class_rows.items():
            self.metrics.device_seconds.inc(
                dur * (rows / total), klass=klass
            )
            self.metrics.fill_ratio.set(round(fill, 4), klass=klass)
        self.metrics.padding_rows.inc(max(0, bucket - total))
        self.ledger.record_round(
            t0,
            class_rows=class_rows,
            requested=total,
            dispatched=bucket,
            devices=devices,
            submissions=n_subs,
            class_subs=class_subs,
            queue_wait_s=t0 - oldest,
            class_queue_wait=class_wait,
            host_prep_s=prep_s,
            device_s=dur,
        )
        self.dispatch_log.append(
            {"n": total, "subs": n_subs, "classes": classes,
             "fill": round(fill, 4), "sharded": devices > 1,
             "devices": devices}
        )
        tracer.add_span(
            "scheduler.queue_wait", oldest, t0 - oldest, n=total
        )
        for sub, _, take in slices:
            if sub.ctx is not None:
                self._ctx_spans(tracer, sub, t0, dur, take)
        tracer.add_span(
            "scheduler.device_round", t0, dur,
            n=total, bucket=bucket, fill=round(fill, 3),
            classes=",".join(classes), coalesced=n_subs,
            sharded=devices > 1, devices=devices,
        )

    # --- failure paths -----------------------------------------------------

    @staticmethod
    def _fail_slices(slices, exc: Exception) -> None:
        for sub, _, _ in slices:
            sub.failed = True  # _take_round drops any queued remainder
            if not sub.future.done():
                sub.future.set_exception(exc)

    def _fail_pending(self, exc: Exception) -> None:
        """Forced-cancel path only — a clean stop() drains instead."""
        for klass in CLASS_ORDER:
            q = self._queues[klass]
            while q:
                sub = q.popleft()
                if not sub.future.done():
                    sub.future.set_exception(exc)


_default_scheduler: Optional[VerifyScheduler] = None


def default_scheduler() -> Optional[VerifyScheduler]:
    return _default_scheduler


def set_default_scheduler(
    sched: Optional[VerifyScheduler],
) -> Optional[VerifyScheduler]:
    """Install `sched` as the process default (node assembly; latest
    wins, like the default tracer). None uninstalls."""
    global _default_scheduler
    _default_scheduler = sched
    return sched


def default_dispatch(klass: str = "consensus"):
    """What callers verify against: the default scheduler's classed
    adapter when one is installed (it self-degrades to direct dispatch
    while not running), else the process-wide verifier. Every
    subsystem's device-verify path funnels through here so one installed
    scheduler captures the whole node."""
    sched = _default_scheduler
    if sched is not None:
        return sched.classed(klass)
    return default_verifier()
