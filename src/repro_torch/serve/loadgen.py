"""Load generation for ``SolveService`` — request mixes + load loops.

Four canonical mixes over a set of registered patterns:

  * ``hot``         — skewed routing (geometric weights): one pattern
                      dominates, the regime where pattern-routed
                      microbatching should shine;
  * ``uniform``     — equal weight per pattern (batching still helps,
                      diluted across routes);
  * ``adversarial`` — every pattern equally cold across many distinct
                      patterns: the worst case for both the plan cache
                      and the batcher (nothing coalesces);
  * ``width``       — one width-class family of distinct patterns
                      (``shifted_coupling_lower``), uniform: the regime
                      of cross-pattern batching.

Two load loops:

  * ``run_closed_loop`` — ``n_clients`` threads, each submits and *waits*
    (classic closed loop: offered load adapts to service latency);
  * ``run_open_loop``   — a paced submitter that does not wait (offered
    load fixed at ``rate_hz``; queue depth reveals saturation).

Both return a JSON-ready report: throughput, p50/p95/p99/p99.9 latency,
error count, and the service's full metrics snapshot. The open
loop additionally reports ``client_latency_us`` — percentiles over
EVERY ticket's submit-to-result time (the service reservoir keeps only
the most recent 4096 samples; a p99.9 acceptance gate needs the full
population). With ``validate=True`` every result is checked *bitwise*
against ``direct_reference`` on the version-pinned solver — the same
contract tests/test_torch_serve.py enforces. With ``keep=[]`` every
served ``(ticket, b, x)`` is appended to the list, for checks the caller
makes afterwards.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.metrics import _percentiles_us
from repro_torch.serve.service import (
    QueueFullError,
    SolveService,
    SolveTicket,
    direct_reference,
)
from repro_torch.sparse.generators import erdos_renyi_lower, shifted_coupling_lower

MIXES = ("hot", "uniform", "adversarial", "width")


def corpus_patterns(
    service: SolveService, **plan_kwargs
) -> List[Tuple[str, int]]:
    """Register the 9-matrix autotune scenario corpus; returns
    ``[(fingerprint, n), ...]`` in corpus order."""
    from repro_torch.autotune import corpus_entries

    out = []
    for e in corpus_entries():
        m = e.matrix()
        out.append((service.register(m, **plan_kwargs), m.n_rows))
    return out


def adversarial_patterns(
    service: SolveService,
    n_patterns: int = 16,
    *,
    n: int = 160,
    density: float = 0.02,
    seed: int = 0,
    **plan_kwargs,
) -> List[Tuple[str, int]]:
    """``n_patterns`` structurally distinct matrices (distinct ER seeds →
    distinct fingerprints): every request routes to its own plan, so the
    batcher can only coalesce same-pattern repeats."""
    out = []
    for i in range(n_patterns):
        m = erdos_renyi_lower(n, density, seed=seed + 1000 + i)
        out.append((service.register(m, **plan_kwargs), m.n_rows))
    return out


def width_class_patterns(
    service: SolveService,
    n_patterns: int = 6,
    *,
    n: int = 96,
    stride: int = 8,
    seed: int = 0,
    **plan_kwargs,
) -> List[Tuple[str, int]]:
    """``n_patterns`` structurally DISTINCT matrices that land in ONE
    width class (``sparse.generators.shifted_coupling_lower`` — same
    ``ExecPlan`` shapes under a level scheduler): the regime where
    cross-pattern batching coalesces requests that classic
    per-fingerprint routing cannot. Asserts the class actually formed —
    a scheduler whose plan shapes depend on the shift values would
    silently degrade the mix into ``adversarial``."""
    if n_patterns > stride - 1:
        raise ValueError(
            f"at most stride-1={stride - 1} distinct shifts exist"
        )
    out = []
    for j in range(n_patterns):
        m = shifted_coupling_lower(n, j, stride=stride, seed=seed + j)
        out.append((service.register(m, **plan_kwargs), m.n_rows))
    classes = {service.pattern(fp).width_class for fp, _ in out}
    if len(classes) != 1:
        raise AssertionError(
            f"width-class family split into {len(classes)} classes — "
            "plan with a level scheduler (strategy='wavefront') so the "
            "plan shapes stay shift-invariant"
        )
    return out


def patterns_for_mix(
    service: SolveService,
    mix: str,
    *,
    n_adversarial: int = 16,
    seed: int = 0,
    **plan_kwargs,
):
    """One-stop setup for a named mix: registers the right pattern set
    (corpus for hot/uniform, distinct ER matrices for adversarial, one
    width-class family for width) and returns ``(patterns, sampler)``.
    Shared by the ``repro_torch.launch.solver_serve`` CLI and its
    callers, so they can never diverge on what a mix means."""
    if mix == "adversarial":
        patterns = adversarial_patterns(
            service, n_adversarial, seed=seed, **plan_kwargs
        )
        kind = "uniform"  # adversity is the pattern count, not the skew
    elif mix == "width":
        # the family needs shift-invariant plan shapes: pin a level
        # scheduler unless the caller chose one explicitly
        patterns = width_class_patterns(
            service, seed=seed, **{"strategy": "wavefront", **plan_kwargs}
        )
        kind = "uniform"  # structure is shared; traffic is spread
    else:
        patterns = corpus_patterns(service, **plan_kwargs)
        kind = mix
    return patterns, make_sampler(patterns, kind, seed=seed)


def mix_weights(kind: str, n_patterns: int) -> np.ndarray:
    """Routing distribution over patterns for a named mix."""
    if kind == "uniform" or kind == "adversarial":
        w = np.ones(n_patterns)
    elif kind == "hot":
        # geometric skew: pattern 0 takes ~half the traffic
        w = 0.5 ** np.arange(n_patterns, dtype=np.float64)
    else:
        raise ValueError(f"unknown mix {kind!r}; expected one of {MIXES}")
    return w / w.sum()


def make_sampler(
    patterns: Sequence[Tuple[str, int]],
    kind: str = "hot",
    *,
    seed: int = 0,
) -> Callable[[], Tuple[str, np.ndarray]]:
    """Thread-safe request sampler: () -> (fingerprint, b). Each call
    draws a pattern from the mix distribution and a fresh Gaussian
    right-hand side."""
    weights = mix_weights(kind, len(patterns))
    lock = threading.Lock()
    rng = np.random.default_rng(seed)

    def sample() -> Tuple[str, np.ndarray]:
        with lock:
            i = int(rng.choice(len(patterns), p=weights))
            fp, n = patterns[i]
            b = rng.standard_normal(n).astype(np.float32)
        return fp, b

    return sample


def _validate_tickets(
    served: List[Tuple[SolveTicket, np.ndarray, np.ndarray]],
) -> int:
    """Bitwise-check served results against the version-pinned solver
    (``ticket.served_by`` — kept on the ticket so the check works even
    after the version retires from the service); returns the mismatch
    count (0 is the contract)."""
    bad = 0
    for ticket, b, x in served:
        ref = direct_reference(
            ticket.served_by, b, ticket.batch_width, ticket.batch_position
        )
        if not np.array_equal(x, ref):
            bad += 1
    return bad


def _report(
    service: SolveService,
    *,
    mode: str,
    n_requests: int,
    elapsed: float,
    errors: int,
    mismatches: Optional[int],
    rejected: int = 0,
    client_latency_us: Optional[dict] = None,
) -> dict:
    snap = service.stats()
    # rejected requests are back-pressure working as designed, not
    # failures — reported separately and excluded from throughput
    completed = n_requests - errors - rejected
    out = {
        "mode": mode,
        "requests": n_requests,
        "completed": completed,
        "elapsed_seconds": round(elapsed, 4),
        "solves_per_sec": round(completed / elapsed, 1) if elapsed else 0.0,
        "errors": errors,
        "rejected": rejected,
        "bitwise_mismatches": mismatches,
        "latency_us": snap["latency_us"],
        "queue_wait_us": snap["queue_wait_us"],
        "mean_batch_size": snap["mean_batch_size"],
        "metrics": snap,
    }
    if client_latency_us is not None:
        out["client_latency_us"] = client_latency_us
    return out


def run_closed_loop(
    service: SolveService,
    sampler: Callable[[], Tuple[str, np.ndarray]],
    *,
    n_clients: int = 8,
    requests_per_client: int = 50,
    validate: bool = False,
    timeout: float = 120.0,
    keep: Optional[list] = None,
) -> dict:
    """``n_clients`` threads, each submitting ``requests_per_client``
    requests back-to-back (waiting for each result)."""
    errors = [0] * n_clients
    rejected = [0] * n_clients
    kept: List[List] = [[] for _ in range(n_clients)]

    def client(ci: int) -> None:
        for _ in range(requests_per_client):
            fp, b = sampler()
            ticket = service.submit(fp, b)
            try:
                x = ticket.result(timeout)
                if validate or keep is not None:
                    kept[ci].append((ticket, b, x))
            except QueueFullError:
                rejected[ci] += 1
            except Exception:
                errors[ci] += 1

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True)
        for i in range(n_clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    served = [s for c in kept for s in c]
    mism = _validate_tickets(served) if validate else None
    if keep is not None:
        keep.extend(served)
    return _report(
        service,
        mode="closed",
        n_requests=n_clients * requests_per_client,
        elapsed=elapsed,
        errors=sum(errors),
        mismatches=mism,
        rejected=sum(rejected),
    )


def run_open_loop(
    service: SolveService,
    sampler: Callable[[], Tuple[str, np.ndarray]],
    *,
    rate_hz: float = 500.0,
    n_requests: int = 200,
    validate: bool = False,
    timeout: float = 120.0,
    keep: Optional[list] = None,
) -> dict:
    """Paced submitter: one request every ``1/rate_hz`` seconds regardless
    of completions, then wait for all tickets. Reports
    ``client_latency_us`` percentiles (incl. p99/p99.9) over every
    completed ticket's submit-to-completion time — the open-loop tail
    the continuous engine is built for."""
    interval = 1.0 / rate_hz
    inflight: List[Tuple[SolveTicket, np.ndarray]] = []
    t0 = time.perf_counter()
    next_t = t0
    for _ in range(n_requests):
        now = time.perf_counter()
        if now < next_t:
            time.sleep(next_t - now)
        fp, b = sampler()
        inflight.append((service.submit(fp, b), b))
        next_t += interval
    errors = 0
    rejected = 0
    served = []
    latencies = []
    for ticket, b in inflight:
        try:
            x = ticket.result(timeout)
        except QueueFullError:
            rejected += 1
            continue
        except Exception:
            errors += 1
            continue
        # t_submit/t_done are stamped on the ticket itself, so the
        # sequential result() collection here does not skew the sample
        latencies.append(ticket.t_done - ticket.t_submit)
        if validate or keep is not None:
            served.append((ticket, b, x))
    elapsed = time.perf_counter() - t0
    mism = _validate_tickets(served) if validate else None
    if keep is not None:
        keep.extend(served)
    return _report(
        service,
        mode=f"open@{rate_hz:g}Hz",
        n_requests=n_requests,
        elapsed=elapsed,
        errors=errors,
        mismatches=mism,
        rejected=rejected,
        client_latency_us=_percentiles_us(np.asarray(latencies)),
    )
