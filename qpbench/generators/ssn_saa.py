"""SSN, the network-planning two-stage stochastic LP of Sen, Doverspike and
Cosares (1994), run as users run it: sample-average approximation (SAA)
replications, each N scenarios drawn and solved as one block-angular LP.

    first stage   x_e >= 0 capacity added to link e, t >= 0 the budget's
                  slack:   sum_e x_e + t = B                (n0 = links + 1, m0 = 1)
    scenario s    f_r >= 0 the flow on route r, u_p >= 0 the unserved
                  demand of pair p, v_e >= 0 link e's slack:
                  sum_{r through e} f_r + v_e - x_e = cap_e     (one row per link)
                  sum_{r of p} f_r + u_p = d_p(omega_s)         (one row per pair)
                                              (ns = routes + pairs + links, ms = links + pairs)
    objective     (1/N) sum_s sum_p u_{p,s}: the sample mean of the unserved
                  demand, the SAA estimate of E sum_p u_p

The recourse is fixed (W and T are the same in every scenario; only b_s
changes) and complete (f = 0, u = d is feasible in every scenario).
SSN's own network data lives in its SMPS files, which the repository does
not hold: the graph, the routes, the capacities, the budget and the
demand distribution are generated from the configuration's
`assumed.network_seed` at SSN's dimensions (`links`, `pairs`, `routes`),
the same in every run; a run's seed draws only the replications'
scenarios.

`make_pool` makes the blocks on the card (the CPU without one): the
scenario stacks W_s and T_s once for the pool, shared by its
replications, which differ only in b_s.  Each replication's host record
for `compare` is a flat sparse `Instance` in the layout of the solver's
flat vectors ([x0; vec(x_s)], rows [row0; vec(rows_s)]), with the block
data beside it (`SAAInstance.blocks`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra

from qpbench.problem import Instance, seed_sequence

MAX_OUTCOMES = 7      # the most outcomes a pair's demand may have


@dataclasses.dataclass(frozen=True)
class SAAInstance(Instance):
    """One replication: the flat record, and its blocks as torch tensors
    on the card (`W_s`, `T_s`, `b_s`, `c_s`, `lb_s`, `ub_s`, `A0`, `b0`,
    `c0`, `lb0`, `ub0`)."""
    blocks: dict = dataclasses.field(repr=False, compare=False)


@dataclasses.dataclass(frozen=True)
class Network:
    links: np.ndarray          # (links, 2) node pairs
    pairs: np.ndarray          # (pairs, 2)
    route_pair: np.ndarray     # (routes,) the pair each route serves
    incidence: np.ndarray      # (links, routes) 1 where the route uses the link
    capacity: np.ndarray       # (links,)
    budget: float
    outcomes: np.ndarray       # (pairs, MAX_OUTCOMES) demand values, padded
    cum_prob: np.ndarray       # (pairs, MAX_OUTCOMES) cumulative, padded with 1


def _route(nodes, links, index, weights, a, b):
    """The links of the shortest path from a to b under `weights`, sorted
    (`index`: link of each ordered node pair)."""
    g = sp.csr_matrix((np.concatenate([weights, weights]),
                       (np.concatenate([links[:, 0], links[:, 1]]),
                        np.concatenate([links[:, 1], links[:, 0]]))), shape=(nodes, nodes))
    _, pred = dijkstra(g, indices=a, return_predecessors=True)
    path, v = [], b
    while v != a:
        u = int(pred[v])
        path.append(index[u, v])
        v = u
    return tuple(sorted(path))


def network(config: dict) -> Network:
    """The network, from `assumed.network_seed` alone."""
    assumed = config["assumed"]
    rng = np.random.default_rng(assumed["network_seed"])
    nodes, n_links, n_pairs, n_routes = (assumed["nodes"], config["links"], config["pairs"],
                                         config["routes"])
    edges = {(int(rng.integers(v)), v) for v in range(1, nodes)}     # a spanning tree
    while len(edges) < n_links:
        u, v = sorted(rng.choice(nodes, 2, replace=False).tolist())
        edges.add((u, v))
    links = np.array(sorted(edges))
    every = np.array([(u, v) for u in range(nodes) for v in range(u + 1, nodes)])
    pairs = every[np.sort(rng.choice(len(every), n_pairs, replace=False))]
    counts = np.full(n_pairs, n_routes // n_pairs)
    counts[rng.choice(n_pairs, n_routes % n_pairs, replace=False)] += 1

    index = {}
    for e, (u, v) in enumerate(links.tolist()):
        index[u, v] = index[v, u] = e
    routes, route_pair = [], []
    for p, (a, b) in enumerate(pairs):
        found, used = [], np.zeros(len(links))
        for _ in range(50 * counts[p]):
            weights = rng.uniform(*assumed["route_weights"], len(links)) * 2.0 ** used
            path = _route(nodes, links, index, weights, a, b)
            used[list(path)] += 1
            if path not in found:
                found.append(path)
            if len(found) == counts[p]:
                break
        if len(found) < counts[p]:
            raise ValueError(f"pair {p}: {len(found)} distinct routes, {counts[p]} wanted")
        routes += found
        route_pair += [p] * counts[p]
    incidence = np.zeros((n_links, n_routes))
    for r, path in enumerate(routes):
        incidence[list(path), r] = 1.0

    lo, hi = assumed["link_capacity"]
    capacity = rng.integers(lo, hi + 1, n_links).astype(np.float64)
    outcomes = np.zeros((n_pairs, MAX_OUTCOMES))
    cum_prob = np.ones((n_pairs, MAX_OUTCOMES))
    fewest, most = assumed["outcomes_per_pair"]
    lo, hi = assumed["demand_values"]
    for p in range(n_pairs):
        k = int(rng.integers(fewest, most + 1))
        outcomes[p, :k] = np.sort(rng.choice(np.arange(lo, hi + 1), k, replace=False))
        outcomes[p, k:] = outcomes[p, k - 1]
        cum_prob[p, :k] = np.cumsum(rng.dirichlet(np.ones(k)))
        cum_prob[p, k - 1:] = 1.0
    return Network(links=links, pairs=pairs, route_pair=np.array(route_pair),
                   incidence=incidence, capacity=capacity, budget=float(assumed["budget"]),
                   outcomes=outcomes, cum_prob=cum_prob)


def draw_demands(net: Network, n: int, rng) -> np.ndarray:
    """(n, pairs) demands, each pair's outcome drawn independently."""
    u = rng.random((n, len(net.pairs)))
    idx = (u[:, :, None] >= net.cum_prob[None]).sum(-1)
    return np.take_along_axis(net.outcomes[None], idx[:, :, None], axis=2)[:, :, 0]


def blocks(net: Network, n: int) -> dict:
    """The fixed blocks in equality form (NumPy) for `n` scenarios: W
    (ms, ns), T (ms, n0), A0, b0, the cost and bound rows of a scenario and
    of the first stage (each scenario's probability 1/n)."""
    n_links, n_routes = net.incidence.shape
    n_pairs = len(net.pairs)
    by_pair = np.zeros((n_pairs, n_routes))
    by_pair[net.route_pair, np.arange(n_routes)] = 1.0
    W = np.block([[net.incidence, np.zeros((n_links, n_pairs)), np.eye(n_links)],
                  [by_pair, np.eye(n_pairs), np.zeros((n_pairs, n_links))]])
    T = np.zeros((n_links + n_pairs, n_links + 1))
    T[np.arange(n_links), np.arange(n_links)] = -1.0
    d_max = net.outcomes.max(1)
    B = net.budget
    return {
        "W": W, "T": T, "A0": np.ones((1, n_links + 1)), "b0": np.array([B]),
        "c0": np.zeros(n_links + 1),
        "c_s": np.concatenate([np.zeros(n_routes), np.full(n_pairs, 1.0 / n), np.zeros(n_links)]),
        "lb0": np.zeros(n_links + 1), "ub0": np.full(n_links + 1, 2.0 * B),
        "lb_s": np.zeros(n_routes + n_pairs + n_links),
        "ub_s": np.concatenate([2.0 * d_max[net.route_pair], 2.0 * d_max,
                                2.0 * (net.capacity + B)]),
    }


def flat_matrix(A0, T, W, n: int) -> sp.csr_matrix:
    """The flat constraint matrix [[A0, 0], [T, W (block-diagonal)]] of n
    scenarios, built as CSR arrays directly."""
    m0, n0 = A0.shape
    ms, ns = W.shape
    head = sp.csr_matrix(np.hstack([A0, np.zeros((m0, ns))]))
    tw = sp.csr_matrix(np.hstack([T, W]))
    scen = np.arange(n, dtype=np.int64)[:, None]
    indices = tw.indices[None, :] + scen * np.where(tw.indices >= n0, ns, 0)[None, :]
    indptr = tw.indptr[1:][None, :] + scen * tw.nnz + head.nnz
    return sp.csr_matrix(
        (np.concatenate([head.data, np.tile(tw.data, n)]),
         np.concatenate([head.indices, indices.ravel()]),
         np.concatenate([head.indptr, indptr.ravel()])),
        shape=(m0 + n * ms, n0 + n * ns))


def make_pool(config: dict, traffic: dict, seed: int):
    """(calls, start): call k solves replication k of `replications`, each
    `scenarios` demand vectors drawn from the seed; the seed also picks the
    call the window starts at."""
    import torch

    net = network(config)
    n = config["scenarios"]
    blk = blocks(net, n)
    dev = "cuda" if torch.cuda.is_available() else "cpu"

    def stack(row):   # a block repeated for every scenario, on the card
        row = torch.as_tensor(row, dtype=torch.float64, device=dev)
        return row.expand(n, *row.shape).contiguous()

    shared = {"W_s": stack(blk["W"]), "T_s": stack(blk["T"]), "c_s": stack(blk["c_s"]),
              "lb_s": stack(blk["lb_s"]), "ub_s": stack(blk["ub_s"])}
    shared.update({k: torch.as_tensor(blk[k], dtype=torch.float64, device=dev)
                   for k in ("A0", "b0", "c0", "lb0", "ub0")})
    A = flat_matrix(blk["A0"], blk["T"], blk["W"], n)
    H = sp.csr_matrix((A.shape[1], A.shape[1]))
    c = np.concatenate([blk["c0"], np.tile(blk["c_s"], n)])
    lvar = np.concatenate([blk["lb0"], np.tile(blk["lb_s"], n)])
    uvar = np.concatenate([blk["ub0"], np.tile(blk["ub_s"], n)])

    calls = []
    for k in range(traffic["replications"]):
        d = draw_demands(net, n, np.random.default_rng(seed_sequence(seed, 2, k)))
        b_s = np.concatenate([np.broadcast_to(net.capacity, (n, len(net.capacity))), d], 1)
        calls.append([SAAInstance(
            name=f"ssn_saa_N{n}_rep{k}", H=H, c=c, A=A,
            b=np.concatenate([blk["b0"], b_s.ravel()]), lvar=lvar, uvar=uvar,
            blocks={**shared, "b_s": torch.as_tensor(b_s, device=dev)})])
    return calls, seed % len(calls)
