"""``repro_torch.serve`` — a batching SpTRSV solve service on top of
``repro_torch.pipeline``, on the card.

Turn a stream of independent solve requests into few large batched
solves: requests sharing a sparsity pattern are coalesced (pattern-routed
microbatching) into one multi-RHS ``solve(B[n, m])`` against the cached
plan, and factor values can be swapped live between microbatches without
corrupting queued work (version-pinned plans). With
``width_class_batching=True`` the coalescing widens to *structurally
identical* patterns (one ``TriangularSolver.width_class``): columns from
different patterns/versions ride one grouped dispatch — on the
``kernel`` backend one launch of the banked level walk — each solved
against its own plan tensors. ``n_workers>1`` executes distinct routes
concurrently. With ``backend="distributed"`` and ``mesh=`` the plans run
across a mesh of card positions (``repro_torch.mesh``), and dispatch widths
are aligned to the mesh's ``data`` axis.

    from repro_torch.serve import SolveService

    with SolveService(max_batch=32, max_wait_us=2000) as svc:
        fp = svc.register(L)            # plan once; cheap handle back
        x = svc.solve(fp, b)            # or submit(fp, b) -> SolveTicket
        svc.numeric_update(fp, new_vals)  # live refactorization
        svc.print_stats()

``mode="continuous"`` swaps microbatch formation for persistent
device-resident RHS slots (``repro_torch.serve.slots``): admission
allocates a free lane, an always-running dispatch loop solves the
resident bank back-to-back, and there is no drain barrier between
dispatches — the open-loop tail-latency regime.

Module map:

  * ``service`` — ``SolveService`` / ``SolveTicket`` (admission, workers)
  * ``batcher`` — pattern-routed microbatching queue (``MicroBatcher``)
    + the continuous engine's ``AdmissionQueue``
  * ``slots``   — continuous batching: ``SlotState`` / ``SlotEngine``
  * ``updates`` — version-tagged plans for live refactorization
  * ``metrics`` — per-pattern + global telemetry (``ServeMetrics``)
  * ``loadgen`` — request-mix load generator (hot / uniform /
    adversarial / width)
"""
from repro_torch.serve.batcher import (
    AdmissionQueue,
    MicroBatcher,
    normalize_max_batch,
    pad_width,
)
from repro_torch.serve.loadgen import (
    MIXES,
    adversarial_patterns,
    corpus_patterns,
    make_sampler,
    mix_weights,
    patterns_for_mix,
    run_closed_loop,
    run_open_loop,
    width_class_patterns,
)
from repro_torch.serve.metrics import LatencyReservoir, ServeMetrics, pretty
from repro_torch.serve.service import (
    GroupReplay,
    QueueFullError,
    SolveService,
    SolveTicket,
    direct_reference,
)
from repro_torch.serve.slots import (
    SlotDispatcher,
    SlotEngine,
    SlotRequest,
    SlotsFull,
    SlotState,
)
from repro_torch.serve.updates import VersionedPlans

__all__ = [
    "AdmissionQueue",
    "MicroBatcher",
    "normalize_max_batch",
    "pad_width",
    "MIXES",
    "adversarial_patterns",
    "corpus_patterns",
    "make_sampler",
    "mix_weights",
    "patterns_for_mix",
    "run_closed_loop",
    "run_open_loop",
    "width_class_patterns",
    "LatencyReservoir",
    "ServeMetrics",
    "pretty",
    "GroupReplay",
    "QueueFullError",
    "SolveService",
    "SolveTicket",
    "direct_reference",
    "SlotDispatcher",
    "SlotEngine",
    "SlotRequest",
    "SlotsFull",
    "SlotState",
    "VersionedPlans",
]
