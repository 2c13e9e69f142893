"""Device time of the match kernel from a jax.profiler trace, as a share of
the HBM bound.

Shapes: the bench cell (S=2M, Wp=68, Q=2048, K=128) and the largest real
batch index (S=39M, Wp=68, Q=10,240, K=128). Bytes a call must move: Q*K
gathered rows of Wp*4 B plus the Q x 32*Wp int32 scores it writes. The
bound is 3.35 TB/s (H100 SXM HBM3, NVIDIA data sheet, at a 700 W power
limit); a plain device copy of the 39M-row index is timed beside it as the
bandwidth the card actually reaches.

Run on the card:  python scripts/dev/match_trace.py [--reps 20]
Prints one JSON line per shape plus the trace's device lines for inspection.
"""

import argparse
import glob
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)


def busy_ns(events) -> float:
    """Length of the union of [start, end) event intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(events):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_busy(logdir: str, show: bool) -> float:
    """Busy nanoseconds of GPU 0 over the whole trace: the union of the
    kernel events on its stream lines."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(f"{logdir}/plugins/profile/*/*.xplane.pb"))[-1]
    planes = list(ProfileData.from_file(path).planes)
    plane = next((p for p in planes if p.name.startswith("/device:GPU:0")), None)
    if plane is None:
        raise SystemExit(f"no GPU plane in the trace: {[p.name for p in planes]}")
    spans = []
    for line in plane.lines:
        evs = [(e.start_ns, e.end_ns, e.name) for e in line.events]
        if show:
            top: dict[str, float] = {}
            for s, e, n in evs:
                top[n] = top.get(n, 0.0) + (e - s)
            best = sorted(top.items(), key=lambda t: -t[1])[:4]
            print(f"  line {line.name!r}: {len(evs)} events; top {best}")
        if line.name.startswith("Stream"):
            spans += [(s, e) for s, e, _ in evs]
    return busy_ns(spans)


def traced(fn, args, reps: int, show: bool) -> float:
    """Device seconds per call of ``fn(*args)``, warm."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        return device_busy(d, show) / reps / 1e9


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from phylign_tpu.ops.match import match_scores_xla
    from phylign_tpu.utils.platform import ensure_backend, gpu_name_and_power_limit

    ensure_backend(require_gpu=True)
    card = gpu_name_and_power_limit()
    print(card)
    key = jax.random.PRNGKey(0)
    wp, k = 68, 128
    for label, s, q in (("bench", 2_000_000, 2048), ("real", 39_000_000, 10240)):
        words = jax.random.bits(key, (s + 1, wp), jnp.uint32).at[s].set(0)
        idx = jax.random.randint(key, (q, k, 1), 0, s, jnp.int32)
        secs = traced(match_scores_xla, (words, idx), args.reps, label == "bench")
        moved = q * k * wp * 4 + q * 32 * wp * 4
        line = {
            "shape": label, "S": s, "Wp": wp, "Q": q, "K": k,
            "device_ms_per_call": secs * 1e3,
            "queries_per_s": q / secs,
            "bytes_per_call": moved,
            "achieved_GBps": moved / secs / 1e9,
            "hbm_bound_share": moved / HBM_BYTES_PER_S / secs,
            "card": card,
        }
        if label == "real":
            copy = jax.jit(lambda w: w + jnp.uint32(1))
            csecs = traced(copy, (words,), args.reps, False)
            line["copy_GBps"] = 2 * words.nbytes / csecs / 1e9
            line["share_of_copy_bandwidth"] = (
                line["achieved_GBps"] / line["copy_GBps"]
            )
        print(json.dumps(line), flush=True)
        del words, idx


if __name__ == "__main__":
    main()
