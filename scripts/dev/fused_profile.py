"""Phase breakdown of the FUSED align flush at a given pool size.

Usage: fused_profile.py [N_PAIRS]

Instruments one begin/end pipelined sequence: per pool, time
  anchors   make_pairs_batch (native anchor collection)
  h2d       jax.device_put calls inside _fused_dispatch
  dispatch  _fused_dispatch minus its device_put time
  finish    _fused_finish (fetch + record assembly)
Upload BYTES are reported too.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

from phylign_tpu.align import engine as ae
from phylign_tpu.kmer import decode_seq
from phylign_tpu.ops import minimizer as opm
from phylign_tpu.utils.jaxcache import enable

enable()

rng = np.random.default_rng(0)
G = 3_000_000
N = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
RL = 150
params = ae.AlignParams.from_preset("sr")

genome = rng.integers(0, 4, G).astype(np.uint8)
ref = opm.build_ref_index("g1", [("c1", genome)], params.k, params.w)
sks = []
for i in range(N):
    s = rng.integers(0, G - RL)
    r = genome[s : s + RL].copy()
    nmut = rng.binomial(RL, 0.01)
    pos = rng.choice(RL, nmut, replace=False)
    r[pos] = (r[pos] + rng.integers(1, 4, nmut)) % 4
    if i % 2:
        r = (3 - r)[::-1].copy()
    sks.append(ae.QuerySketch.make(f"r{i}", decode_seq(r).decode(), params))

import jax
import jax.numpy as jnp

float(jnp.zeros((8,)).sum())  # claim device

T: dict[str, float] = {}
B: dict[str, int] = {}

orig_put = jax.device_put


def timed_put(x, *a, **k):
    t0 = time.perf_counter()
    out = orig_put(x, *a, **k)
    T["h2d"] = T.get("h2d", 0.0) + time.perf_counter() - t0
    for leaf in jax.tree_util.tree_leaves(x):
        if hasattr(leaf, "nbytes"):
            B["h2d"] = B.get("h2d", 0) + leaf.nbytes
    return out


def timed(name, fn):
    def wrap(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        T[name] = T.get(name, 0.0) + time.perf_counter() - t0
        return out

    return wrap


ae._fused_dispatch_inner = ae._fused_dispatch
ae._fused_dispatch = timed("dispatch_total", ae._fused_dispatch_inner)
ae._fused_finish_inner = ae._fused_finish
ae._fused_finish = timed("finish", ae._fused_finish_inner)
jax.device_put = timed_put
_orig_get = jax.device_get
jax.device_get = timed("d2h_get", _orig_get)

for rep in range(5):
    T.clear()
    B.clear()
    t0 = time.perf_counter()
    pairs = ae.make_pairs_batch(ref, sks, params)
    t1 = time.perf_counter()
    recs = ae.flush_pairs(pairs, params, fused=True)
    t2 = time.perf_counter()
    disp_host = T.get("dispatch_total", 0.0) - T.get("h2d", 0.0)
    fin_host = T.get("finish", 0.0) - T.get("d2h_get", 0.0)
    print(
        f"rep{rep}: anchors {t1-t0:.3f}  h2d {T.get('h2d',0):.3f} "
        f"({B.get('h2d',0)/1e6:.2f} MB)  dispatch-host {disp_host:.3f}  "
        f"wait+fetch {T.get('d2h_get',0):.3f}  assemble {fin_host:.3f}  "
        f"total {t2-t0:.3f}  -> {N/(t2-t0):.0f} pairs/s  "
        f"({sum(1 for r in recs if r.flag != 4)} mapped)"
    )

# pipelined cadence split (the production begin/end structure)
M = 6
T.clear()
B.clear()
t0 = time.perf_counter()
pending = None
done = 0
for _ in range(M):
    pairs = ae.make_pairs_batch(ref, sks, params)
    nxt = ae.flush_pairs_begin(pairs, params, fused=True)
    if pending is not None:
        done += len(ae.flush_pairs_end(pending))
    pending = nxt
done += len(ae.flush_pairs_end(pending))
dt = time.perf_counter() - t0
disp_host = T.get("dispatch_total", 0.0) - T.get("h2d", 0.0)
fin_host = T.get("finish", 0.0) - T.get("d2h_get", 0.0)
print(
    f"pipe: {M*N/dt:.0f} pairs/s over {M} pools ({dt:.2f}s) | per-pool "
    f"h2d {T.get('h2d',0)/M:.3f}  dispatch-host {disp_host/M:.3f}  "
    f"wait+fetch {T.get('d2h_get',0)/M:.3f}  assemble {fin_host/M:.3f}"
)
