"""Task placement: IFS (Alg. 2), ETP (Alg. 3) and the DistDGL baseline.

A port of the JAX package's ``repro.core.placement`` onto the torch
engine: the same IFS packing, DistDGL heuristic and MCMC chains (rng
streams, memo caches and accept rules unchanged), with ``device=`` in
place of ``backend=`` threaded to every simulation.

Stores are pre-placed one per machine (constraint (3)): store g lives on
machine g.  IFS packs the remaining samplers/workers/PSs with a DP over
per-machine count tuples; ETP then explores the placement space with
Metropolis-Hastings moves under relaxed capacities (paper §V-B).
"""
from __future__ import annotations

import inspect
import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cluster import (
    PS,
    SAMPLER,
    STORE,
    WORKER,
    ClusterSpec,
    Placement,
    is_feasible,
    violation_fraction,
)
from .engine import (
    DeviceLike,
    expected_makespan,
    mean_batch_makespans,
    monte_carlo_draws,
)
from .multijob import SEED_NS_CHAIN, derive_seed
from .workload import Realization, Workload
from ..obs import metrics as obs_metrics


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _group_indices(workload: Workload) -> Dict[str, List[int]]:
    out: Dict[str, List[int]] = {STORE: [], SAMPLER: [], WORKER: [], PS: []}
    for i, t in enumerate(workload.tasks):
        out[t.kind].append(i)
    return out


def _kind_demand(workload: Workload, cluster: ClusterSpec, kind: str) -> np.ndarray:
    for t in workload.tasks:
        if t.kind == kind:
            return np.array(
                [float(t.demand.get(r, 0.0)) for r in cluster.resource_types]
            )
    return np.zeros(cluster.R)


def store_placement(workload: Workload, cluster: ClusterSpec) -> np.ndarray:
    """store g -> machine g (constraint (3)).  Multi-job merged workloads
    wrap around: each job's store g shares machine g (core/multijob.py)."""
    groups = _group_indices(workload)
    y = np.full(workload.J, -1, dtype=np.int64)
    for g, j in enumerate(groups[STORE]):
        y[j] = g % cluster.M
    return y


# ---------------------------------------------------------------------------
# IFS — Initial Feasible Solution (Alg. 2)
# ---------------------------------------------------------------------------
def ifs_placement(
    workload: Workload,
    cluster: ClusterSpec,
    seed: int = 0,
) -> Placement:
    """DP over per-machine packing tuples; returns the first complete
    feasible placement (Theorem 2: polynomial time)."""
    rng = np.random.default_rng(seed)
    groups = _group_indices(workload)
    n_s, n_w, n_p = len(groups[SAMPLER]), len(groups[WORKER]), len(groups[PS])
    d_s = _kind_demand(workload, cluster, SAMPLER)
    d_w = _kind_demand(workload, cluster, WORKER)
    d_p = _kind_demand(workload, cluster, PS)
    d_g = _kind_demand(workload, cluster, STORE)

    order = rng.permutation(cluster.M)
    # residual capacity after the pinned store(s) on each machine
    resid = cluster.cap.copy()
    for g, _ in enumerate(groups[STORE]):
        resid[g % cluster.M] -= d_g
    if np.any(resid < -1e-9):
        raise ValueError("graph store does not fit on its machine")

    def eta(cap: np.ndarray, d: np.ndarray, n: int) -> int:
        """Max count of a task kind that fits in cap."""
        if n == 0:
            return 0
        with np.errstate(divide="ignore"):
            per = np.where(d > 0, cap / np.where(d > 0, d, 1.0), np.inf)
        return int(min(n, max(0.0, np.floor(per.min() + 1e-9))))

    def fits(cap: np.ndarray, qs: int, qw: int, qp: int) -> bool:
        return bool(np.all(qs * d_s + qw * d_w + qp * d_p <= cap + 1e-9))

    # Omega: dict (qs, qw, qp) -> partial assignment [(mi, qs, qw, qp), ...]
    omega: Dict[Tuple[int, int, int], List[Tuple[int, int, int, int]]] = {}
    for i, mi in enumerate(order):
        cap = resid[mi]
        es, ew, ep = eta(cap, d_s, n_s), eta(cap, d_w, n_w), eta(cap, d_p, n_p)
        local: List[Tuple[int, int, int]] = [
            (qs, qw, qp)
            for qs in range(es + 1)
            for qw in range(ew + 1)
            for qp in range(ep + 1)
            if fits(cap, qs, qw, qp)
        ]
        if i == 0:
            new_omega = {
                (qs, qw, qp): [(int(mi), qs, qw, qp)] for qs, qw, qp in local
            }
        else:
            new_omega = dict(omega)
            for (qs0, qw0, qp0), assign in omega.items():
                # completion check: can the remainder fit entirely on mi?
                rs, rw, rp = n_s - qs0, n_w - qw0, n_p - qp0
                if rs <= es and rw <= ew and rp <= ep and fits(cap, rs, rw, rp):
                    full = assign + [(int(mi), rs, rw, rp)]
                    return _materialize(workload, cluster, full, groups)
                for qs1, qw1, qp1 in local:
                    key = (
                        min(qs0 + qs1, n_s),
                        min(qw0 + qw1, n_w),
                        min(qp0 + qp1, n_p),
                    )
                    if (
                        qs0 + qs1 <= n_s
                        and qw0 + qw1 <= n_w
                        and qp0 + qp1 <= n_p
                        and key not in new_omega
                    ):
                        new_omega[key] = assign + [(int(mi), qs1, qw1, qp1)]
        omega = new_omega
        if (n_s, n_w, n_p) in omega:
            return _materialize(workload, cluster, omega[(n_s, n_w, n_p)], groups)
    raise ValueError("IFS: no feasible placement exists for this job/cluster")


def _materialize(
    workload: Workload,
    cluster: ClusterSpec,
    assign: List[Tuple[int, int, int, int]],
    groups: Dict[str, List[int]],
) -> Placement:
    """Turn count tuples into a concrete Placement.

    Identities are assigned to keep a worker's samplers as close as possible
    (workers first, then their samplers machine-greedily) — IFS only
    guarantees feasibility; ETP improves quality afterwards."""
    y = store_placement(workload, cluster)
    slots_s: List[int] = []
    slots_w: List[int] = []
    slots_p: List[int] = []
    for (m, qs, qw, qp) in assign:
        slots_s += [m] * qs
        slots_w += [m] * qw
        slots_p += [m] * qp
    for j, m in zip(groups[WORKER], slots_w):
        y[j] = m
    # samplers: try to give each worker its samplers on the worker's machine
    remaining = list(slots_s)
    for w in groups[WORKER]:
        for s in workload.sampler_of_worker.get(w, []):
            wm = int(y[w])
            if wm in remaining:
                remaining.remove(wm)
                y[s] = wm
    unplaced = [s for s in groups[SAMPLER] if y[s] < 0]
    for s, m in zip(unplaced, remaining):
        y[s] = m
    for j, m in zip(groups[PS], slots_p):
        y[j] = m
    assert np.all(y >= 0)
    return Placement(y)


# ---------------------------------------------------------------------------
# DistDGL baseline placement (§VI-A)
# ---------------------------------------------------------------------------
def distdgl_placement(workload: Workload, cluster: ClusterSpec) -> Placement:
    """Maximally colocate each worker with its samplers (and its 'home'
    graph partition, round-robin), spilling to the least-loaded feasible
    machine when resources run out — mirroring the paper's description of
    DistDGL, including the forced worker/sampler separations it suffers."""
    y = store_placement(workload, cluster)
    groups = _group_indices(workload)
    demands = cluster.demand_matrix(workload.tasks)
    usage = np.zeros((cluster.M, cluster.R))
    for j, m in enumerate(y):
        if m >= 0:
            usage[m] += demands[j]

    def fits_on(j: int, m: int) -> bool:
        return bool(np.all(usage[m] + demands[j] <= cluster.cap[m] + 1e-9))

    def place(j: int, pref: Sequence[int]) -> None:
        for m in pref:
            if fits_on(j, m):
                usage[m] += demands[j]
                y[j] = m
                return
        # least-loaded fallback by max fractional utilisation
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.where(cluster.cap > 0, usage / np.maximum(cluster.cap, 1e-9), 0)
        order = np.argsort(frac.max(axis=1))
        for m in order:
            if fits_on(j, int(m)):
                usage[int(m)] += demands[j]
                y[j] = int(m)
                return
        raise ValueError("DistDGL placement infeasible: cluster too small")

    for i, w in enumerate(groups[WORKER]):
        home = i % cluster.M
        place(w, [home] + list(range(cluster.M)))
        for s in workload.sampler_of_worker.get(w, []):
            place(s, [int(y[w])])  # colocate with worker if at all possible
    for p in groups[PS]:
        place(p, [])
    return Placement(y)


# ---------------------------------------------------------------------------
# ETP — Exploratory Task Placement (Alg. 3)
# ---------------------------------------------------------------------------
@dataclass
class ETPResult:
    placement: Placement
    cost_trace: List[float]
    best_makespan: float
    evaluations: int
    cache_hits: int
    wall_time_s: float
    # True when the returned placement could not be certified feasible
    # (search found nothing feasible and neither the warm start nor the
    # IFS fallback passes the capacity check); multi-chain best-of
    # deprioritises such results
    fallback: bool = False
    # MCMC acceptance telemetry: moves drawn / moves Metropolis-accepted
    # (self-loop draws with no host machine count as proposals)
    proposals: int = 0
    accepted: int = 0
    # multi-chain runs: one dict per chain (objective trajectory,
    # evals, hits, acceptance) — the winning chain's numbers are the
    # scalar fields above
    chain_stats: Optional[List[dict]] = None


def group_move_candidates(
    cluster: ClusterSpec,
    demands: np.ndarray,
    usage: np.ndarray,
    y: np.ndarray,
    move_set: Sequence[int],
    mu: float,
) -> List[int]:
    """M_avail for an MCMC (group) move: machines that can host every task
    in ``move_set`` under the relaxed ``(1+mu)`` capacity (eq. 22).

    The post-move usage of candidate ``m`` is
    ``usage[m] + d_move - on_m[m]``: members of the move set that already
    reside on ``m`` contribute to ``usage[m]``, so their demand must not be
    counted twice (a group move frequently drags samplers that already sit
    on the destination).  The primary task's current machine is excluded,
    matching Alg. 3's "move somewhere else" semantics."""
    m_old = int(y[move_set[0]])
    d_move = demands[list(move_set)].sum(axis=0)
    on_m = np.zeros((cluster.M, demands.shape[1]))
    for jj in move_set:
        on_m[int(y[jj])] += demands[jj]
    return [
        m
        for m in range(cluster.M)
        if m != m_old
        and np.all(usage[m] + d_move - on_m[m] <= cluster.cap[m] * (1 + mu) + 1e-9)
    ]


class _Chain:
    """One MCMC chain of Alg. 3, step-decomposed (propose / settle) so that
    independent chains can advance in lock-step with their candidate
    placements evaluated in one simulation batch.  ``etp_search`` drives a
    single chain sequentially; ``etp_multichain`` drives many."""

    def __init__(
        self,
        workload: Workload,
        cluster: ClusterSpec,
        *,
        budget: int,
        mu: float,
        beta: float | str,
        sim_iters: int,
        sim_draws: int,
        seed: int,
        init: Optional[Placement],
        policy: str,
        cost_fn: Optional[Callable[[Placement], float]],
        group_moves: float,
        anneal: bool,
        extra_violation: Optional[Callable[[Placement], float]] = None,
        device: DeviceLike = None,
    ) -> None:
        self.workload = workload
        self.cluster = cluster
        self.budget = budget
        self.mu = mu
        self.beta = beta
        self.sim_iters = sim_iters
        self.sim_draws = sim_draws
        self.seed = seed
        self.init_arg = init
        self.policy = policy
        self.cost_fn = cost_fn
        self.group_moves = group_moves
        self.anneal = anneal
        self.extra_violation = extra_violation
        self.device = device

        self.rng = np.random.default_rng(seed)
        groups = _group_indices(workload)
        self.movable = groups[SAMPLER] + groups[WORKER] + groups[PS]
        self.demands = cluster.demand_matrix(workload.tasks)
        self.cur = (init or ifs_placement(workload, cluster, seed=seed)).copy()
        self.cache: Dict[bytes, Tuple[float, float]] = {}
        self.evals = 0
        self.hits = 0
        self.proposals = 0
        self.accepted = 0
        self.trace: List[float] = []
        self.best: Optional[Placement] = None
        self.best_t = math.inf
        self.usage = np.zeros((cluster.M, cluster.R))
        np.add.at(self.usage, self.cur.y, self.demands)
        self.pending: Optional[Tuple[List[int], int, Placement]] = None
        # The chain's Monte-Carlo draws are a pure function of (seed,
        # sim_iters): realize once, reuse every evaluation (bit-identical to
        # re-realizing inside expected_makespan each time).
        self.reals: List[Realization] = (
            monte_carlo_draws(
                workload, seed=seed, n_iters=sim_iters, n_draws=sim_draws
            )
            if cost_fn is None
            else []
        )

    # -- memoised cost ----------------------------------------------------
    def lookup(self, p: Placement) -> Optional[Tuple[float, float]]:
        got = self.cache.get(p.key())
        if got is not None:
            self.hits += 1
        return got

    def store(self, p: Placement, t: float) -> Tuple[float, float]:
        self.evals += 1
        v = violation_fraction(self.cluster, self.demands, p)
        if self.extra_violation is not None:
            v += self.extra_violation(p)
        c = t * (1.0 + v)
        self.cache[p.key()] = (t, c)
        return t, c

    def measure_scalar(self, p: Placement) -> Tuple[float, float]:
        got = self.lookup(p)
        if got is not None:
            return got
        if self.cost_fn is not None:
            t = self.cost_fn(p)
        else:
            t = expected_makespan(
                self.workload, self.cluster, p, policy=self.policy,
                n_iters=self.sim_iters, n_draws=self.sim_draws, seed=self.seed,
                device=self.device,
            )
        return self.store(p, t)

    def feasible(self, p: Placement) -> bool:
        """Capacity feasibility for best-placement gating: base demands
        and, when the hook is set, a clean extra-violation bill (a
        candidate whose cache reservation overflows memory must not win
        best-of even if its raw makespan is lowest)."""
        if not is_feasible(self.cluster, self.demands, p):
            return False
        return self.extra_violation is None or self.extra_violation(p) <= 1e-12

    # -- MCMC steps -------------------------------------------------------
    def begin(self, cur_tc: Tuple[float, float]) -> None:
        self.cur_t, self.cur_cost = cur_tc
        if self.beta == "auto":
            self.beta = 4.0 / max(0.05 * self.cur_cost, 1e-9)
        if self.feasible(self.cur):
            self.best = self.cur.copy()
            self.best_t = self.cur_t
        self.trace = [self.cur_cost]

    def propose(self, z: int) -> Optional[Placement]:
        """Draw step ``z``'s move; None when no machine can host it (the
        step is then a self-loop, already recorded in the trace)."""
        rng = self.rng
        self.beta_z = self.beta
        if self.anneal and self.budget > 1:
            self.beta_z = (self.beta / 4.0) * (16.0 ** (z / (self.budget - 1)))
        self.proposals += 1
        j = int(rng.choice(self.movable))
        move_set = [j]
        if (
            self.group_moves > 0
            and j in self.workload.sampler_of_worker
            and rng.random() < self.group_moves
        ):
            move_set = [j] + list(self.workload.sampler_of_worker[j])
        cand = group_move_candidates(
            self.cluster, self.demands, self.usage, self.cur.y, move_set, self.mu
        )
        if not cand:
            self.trace.append(self.cur_cost)
            return None
        m_new = int(rng.choice(cand))
        prop = self.cur.copy()
        for jj in move_set:
            prop.y[jj] = m_new
        self.pending = (move_set, m_new, prop)
        return prop

    def settle(self, prop_t: float, prop_cost: float) -> None:
        move_set, m_new, prop = self.pending
        self.pending = None
        # best-placement bookkeeping is independent of acceptance: the
        # candidate is already measured, so a feasible improvement counts
        # even when Metropolis rejects the move (the paper's Alg. 3 only
        # recorded accepted states, discarding evaluated optima for free)
        if prop_t < self.best_t and self.feasible(prop):
            self.best, self.best_t = prop.copy(), prop_t
        accept_p = min(1.0, math.exp(min(50.0, self.beta_z * (self.cur_cost - prop_cost))))
        if self.rng.random() <= accept_p:
            self.accepted += 1
            for jj in move_set:
                self.usage[int(self.cur.y[jj])] -= self.demands[jj]
                self.usage[m_new] += self.demands[jj]
            self.cur, self.cur_t, self.cur_cost = prop, prop_t, prop_cost
        self.trace.append(self.cur_cost)

    def result(self, wall_time_s: float) -> ETPResult:
        best, best_t = self.best, self.best_t
        fallback = best is None
        if fallback:
            # fall back to the feasible IFS start (always feasible, Thm. 2).
            # A warm-start init (DistDGL, replan) carries no feasibility
            # guarantee, so it is only used if it happens to be feasible —
            # or as the very last resort when IFS itself cannot place the
            # job (re-planning on an overloaded shrunken cluster).
            best = self.init_arg
            if best is None or not self.feasible(best):
                try:
                    best = ifs_placement(self.workload, self.cluster, seed=self.seed)
                except ValueError:
                    best = self.init_arg  # not None: __init__'s IFS succeeded
            best_t, _ = self.measure_scalar(best)
            # a fallback that passes every active feasibility check is a
            # legitimate result and competes on makespan in _best_of; the
            # flag only marks placements returned WITHOUT that guarantee
            fallback = not self.feasible(best)
        if obs_metrics.REGISTRY.enabled:
            obs_metrics.REGISTRY.counter("etp.evaluations").inc(self.evals)
            obs_metrics.REGISTRY.counter("etp.cache_hits").inc(self.hits)
            obs_metrics.REGISTRY.counter("etp.proposals").inc(self.proposals)
            obs_metrics.REGISTRY.counter("etp.accepted").inc(self.accepted)
        return ETPResult(
            placement=best,
            cost_trace=self.trace,
            best_makespan=best_t,
            evaluations=self.evals,
            cache_hits=self.hits,
            wall_time_s=wall_time_s,
            fallback=fallback,
            proposals=self.proposals,
            accepted=self.accepted,
        )

    def stats(self) -> dict:
        """Per-chain telemetry row: light enough to
        attach to every multi-chain result unconditionally."""
        return {
            "seed": self.seed,
            "evaluations": self.evals,
            "cache_hits": self.hits,
            "proposals": self.proposals,
            "accepted": self.accepted,
            "acceptance_rate": self.accepted / max(self.proposals, 1),
            "best_makespan": float(self.best_t),
            "objective_trajectory": [float(c) for c in self.trace],
        }


def etp_search(
    workload: Workload,
    cluster: ClusterSpec,
    *,
    budget: int = 2000,
    mu: float = 1.0,
    beta: float | str = "auto",
    sim_iters: int = 20,
    sim_draws: int = 1,
    seed: int = 0,
    init: Optional[Placement] = None,
    policy: str = "oes",
    cost_fn: Optional[Callable[[Placement], float]] = None,
    time_budget_s: Optional[float] = None,
    group_moves: float = 0.35,
    anneal: bool = True,
    extra_violation: Optional[Callable[[Placement], float]] = None,
    device: DeviceLike = None,
) -> ETPResult:
    """MCMC search (Alg. 3). ``budget`` = I transitions; ``mu`` = relaxed
    capacity factor (eq. 22); ``beta`` = temperature (eq. 23).

    ``beta="auto"`` scales the paper's fixed 0.1 to the job's cost
    magnitude: beta = 4 / (5% of the initial cost), i.e. a 5% makespan
    change carries logit 4 regardless of whether makespans are seconds or
    hours (the paper's 0.1 presumes makespans of O(100 s)).

    The cost is the paper's eq. (21): ``T'_Y * (1 + violation%)`` with
    T'_Y from simulating the workload's traffic profile under ``policy``.
    With ``sim_draws > 1`` the draws run in one ``simulate_batch_torch``
    call.  ``cost_fn`` (placement -> seconds) replaces the simulated
    T'_Y: the re-planner's objective, which prices migration flows, comes
    in here.

    Beyond-paper extensions, both ablatable back to Alg. 3 semantics
    (``group_moves=0, anneal=False, beta=0.1``):
      * ``group_moves``: with this probability a selected *worker* drags its
        dedicated samplers along — single-task moves cannot escape the
        colocation basins that IFS starts in without crossing high-cost
        valleys;
      * ``anneal``: geometric beta ramp from beta/4 to 4*beta over the
        budget (explore -> exploit).

    ``extra_violation`` (placement -> fraction) extends eq. 21's capacity
    penalty with costs the demand matrix cannot express: the feature
    cache's per-machine memory reservation (``repro_torch.cache.planner``)
    depends on where samplers land, not just on how many there are.  A
    candidate with a non-zero bill is not feasible for best-of.

    ``device`` is where the simulations run (``engine.resolve_device``:
    ``None`` means the CUDA card)."""
    t0 = time.perf_counter()
    chain = _Chain(
        workload, cluster, budget=budget, mu=mu, beta=beta, sim_iters=sim_iters,
        sim_draws=sim_draws, seed=seed, init=init, policy=policy,
        cost_fn=cost_fn, group_moves=group_moves, anneal=anneal,
        extra_violation=extra_violation, device=device,
    )
    chain.begin(chain.measure_scalar(chain.cur))
    for z in range(budget):
        if time_budget_s is not None and time.perf_counter() - t0 > time_budget_s:
            break
        prop = chain.propose(z)
        if prop is None:
            continue
        prop_t, prop_cost = chain.measure_scalar(prop)
        chain.settle(prop_t, prop_cost)
    return chain.result(time.perf_counter() - t0)


def _best_of(a: Optional[ETPResult], b: ETPResult) -> ETPResult:
    """Best-of for multi-chain search: a certified-feasible placement
    always beats an uncertified fallback; ties on that status resolve by
    makespan."""
    if a is None:
        return b
    if a.fallback != b.fallback:
        return b if a.fallback else a
    return b if b.best_makespan < a.best_makespan else a


def _chain_defaults() -> Dict[str, object]:
    """The _Chain keyword defaults, read off ``etp_search``'s signature so
    that the single-chain and multi-chain searches cannot drift apart."""
    sig = inspect.signature(etp_search)
    return {
        k: sig.parameters[k].default
        for k in (
            "mu", "beta", "sim_iters", "sim_draws", "policy", "cost_fn",
            "group_moves", "anneal", "extra_violation", "device",
        )
    }


def etp_multichain(
    workload: Workload,
    cluster: ClusterSpec,
    *,
    n_chains: int = 4,
    budget: int = 2000,
    seed: int = 0,
    include_baseline_inits: bool = True,
    time_budget_s: Optional[float] = None,
    batch_cost_fn: Optional[Callable[[Sequence[Placement]], List[float]]] = None,
    **kw: Any,
) -> ETPResult:
    """Beyond-paper: independent MCMC chains from diverse starts (random IFS
    machine orders + the DistDGL colocation heuristic), best-of.  The
    chains advance in LOCK-STEP: each step, every chain's proposal is
    evaluated in ONE ``simulate_batch_torch`` call (batch width = pending
    chains x sim_draws), so placement-evaluations/sec scale with the chain
    count while per-chain semantics — rng streams, caches, accept rules —
    stay those of a chain searched alone.  Each chain gets
    ``budget // n_chains`` transitions.

    ``batch_cost_fn`` (many placements -> makespans) replaces the
    simulated cost with an objective batched elsewhere: the multi-job
    merged workloads (``core.multijob``) and the cache-adjusted traffic
    (``cache.planner``).  Precedence: an explicit scalar ``cost_fn``, then
    ``batch_cost_fn``, then simulation.

    ``**kw`` takes ``etp_search``'s search options; ``device=`` is where
    the pooled evaluations run."""
    per = max(1, budget // n_chains)

    def chain_init(c: int) -> Optional[Placement]:
        if include_baseline_inits and c == 1:
            try:
                return distdgl_placement(workload, cluster)
            except ValueError:
                return None
        return None

    t0 = time.perf_counter()
    params = _chain_defaults()
    params.update(kw)
    explicit_cost_fn = params["cost_fn"]
    if batch_cost_fn is not None and explicit_cost_fn is None:
        # the chains then draw no Monte-Carlo realizations of their own
        params["cost_fn"] = lambda p: batch_cost_fn([p])[0]
    chains = [
        _Chain(
            workload, cluster, budget=per,
            seed=derive_seed(seed, SEED_NS_CHAIN, c),
            init=chain_init(c), **params,
        )
        for c in range(n_chains)
    ]

    def measure_pooled(
        pairs: List[Tuple[_Chain, Placement]]
    ) -> List[Tuple[float, float]]:
        """Memoised cost for many (chain, placement) pairs; all cache
        misses share one ``simulate_batch_torch`` call (or one
        ``batch_cost_fn`` call)."""
        out: Dict[int, Tuple[float, float]] = {}
        need: List[int] = []
        for i, (ch, p) in enumerate(pairs):
            got = ch.lookup(p)
            if got is not None:
                out[i] = got
            else:
                need.append(i)
        if need:
            if explicit_cost_fn is not None:
                ts = [explicit_cost_fn(pairs[i][1]) for i in need]
            elif batch_cost_fn is not None:
                ts = batch_cost_fn([pairs[i][1] for i in need])
            else:
                ts = mean_batch_makespans(
                    workload, cluster,
                    [(pairs[i][1], pairs[i][0].reals) for i in need],
                    policy=params["policy"],
                    device=params["device"],
                )
            for i, t in zip(need, ts):
                ch, p = pairs[i]
                out[i] = ch.store(p, t)
        return [out[i] for i in range(len(pairs))]

    for ch, tc in zip(chains, measure_pooled([(ch, ch.cur) for ch in chains])):
        ch.begin(tc)
    for z in range(per):
        if time_budget_s is not None and time.perf_counter() - t0 > time_budget_s:
            break
        pending = [(ch, ch.propose(z)) for ch in chains]
        pending = [(ch, p) for ch, p in pending if p is not None]
        if not pending:
            continue
        for (ch, _), tc in zip(pending, measure_pooled(pending)):
            ch.settle(*tc)
    wall = time.perf_counter() - t0
    best_r: Optional[ETPResult] = None
    for ch in chains:
        best_r = _best_of(best_r, ch.result(wall))
    assert best_r is not None
    best_r.chain_stats = [ch.stats() for ch in chains]
    return best_r


def remap_after_leave(
    workload: Workload,
    cluster: ClusterSpec,
    placement: Placement,
    leaving_machine: int,
) -> Tuple[ClusterSpec, Placement]:
    """Incumbent-preserving remap when a machine leaves (fails or is
    decommissioned): surviving tasks keep their machines (indices shifted
    onto the reduced cluster) and the orphaned tasks greedily land on the
    least-loaded survivors.  This is the warm start every leave-path
    re-plan begins from.

    Note graph stores are re-pinned: the failed machine's partition is
    re-hosted on the machine with the most free memory (in practice it is
    restored from replicated storage); its tasks join the movable set."""
    survivors = [m for m in range(cluster.M) if m != leaving_machine]
    remap = {m: i for i, m in enumerate(survivors)}
    new_cluster = cluster.without_machine(leaving_machine)
    demands = new_cluster.demand_matrix(workload.tasks)
    y = np.array([remap.get(int(m), -1) for m in placement.y], dtype=np.int64)
    usage = np.zeros((new_cluster.M, new_cluster.R))
    for j, m in enumerate(y):
        if m >= 0:
            usage[m] += demands[j]
    for j in np.where(y < 0)[0]:
        head = np.argsort((usage / np.maximum(new_cluster.cap, 1e-9)).max(axis=1))
        placed = False
        for m in head:
            if np.all(usage[m] + demands[j] <= new_cluster.cap[m] * 2.0):
                usage[m] += demands[j]
                y[j] = int(m)
                placed = True
                break
        if not placed:  # pragma: no cover - extreme overload
            y[j] = int(head[0])
            usage[int(head[0])] += demands[j]
    return new_cluster, Placement(y)


def replan_after_failure(
    workload: Workload,
    cluster: ClusterSpec,
    placement: Placement,
    failed_machine: int,
    *,
    budget: int = 300,
    seed: int = 0,
    **kw: Any,
) -> ETPResult:
    """Fault-tolerance path: machine fails -> ``remap_after_leave`` -> ETP
    warm-started from the remapped incumbent on the reduced cluster."""
    new_cluster, warm = remap_after_leave(
        workload, cluster, placement, failed_machine
    )
    return etp_search(
        workload, new_cluster, budget=budget, seed=seed, init=warm, **kw
    )
