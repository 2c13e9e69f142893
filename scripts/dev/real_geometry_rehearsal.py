"""Real-geometry rehearsal of the row-chunked match path.

The largest real 661k batch decompresses to ~10.59 GB: ~39M Bloom rows x
2,169 documents (computed from
/root/reference/data/decompressed_indexes_sizes.txt — the reference's RAM
accountant input, Snakefile:41-82). On a card whose device budget
(``device_hbm_gb``) cannot hold it resident, the pipeline streams it through
models.matcher.ChunkedMatcher (stages._score_batch_chunked). This script
measures that path at scale within a given per-chunk budget: queries/s,
streamed rows/s and device memory. (The resident path at the same geometry
is phase 4 of chip_smoke.py.)

Run:  python scripts/dev/real_geometry_rehearsal.py [--rows 39000000]
Writes a JSON line to stdout.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=39_000_000)
    ap.add_argument("--docs", type=int, default=2_169)
    ap.add_argument("--reads", type=int, default=10_240)
    ap.add_argument("--budget-mb", type=int, default=2048,
                    help="per-chunk device-memory budget (stages.py uses "
                    "the device budget minus the align reserve)")
    ap.add_argument("--threshold", type=float, default=0.7)
    ap.add_argument("--topn", type=int, default=100)
    args = ap.parse_args()

    from phylign_tpu.utils.platform import ensure_backend

    ensure_backend()
    import jax

    dev = jax.devices()[0]
    print(f"backend: {dev.platform} {dev.device_kind}", file=sys.stderr)

    S, D = args.rows, args.docs
    wp = (D + 31) // 32
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    # density ~0.5 random bits; gather/popcount cost is density-independent
    words = rng.integers(0, 1 << 32, size=(S, wp), dtype=np.uint32)
    gen_s = time.perf_counter() - t0
    nbytes = words.nbytes
    print(f"index: {S}x{D} ({nbytes/1e9:.2f} GB) in {gen_s:.1f}s",
          file=sys.stderr)

    from phylign_tpu.io.cobs import DeviceIndex
    from phylign_tpu.kmer import cobs_kmer_hashes_batch, encode_seq
    from phylign_tpu.models.matcher import ChunkedMatcher

    didx = DeviceIndex(
        term_size=31, num_hashes=1, signature_size=S,
        doc_names=[f"r{i}_SAMEA{i:07d}" for i in range(D)], words=words,
    )
    reads = [rng.choice(np.frombuffer(b"ACGT", np.uint8), 150).tobytes()
             for _ in range(args.reads)]
    t0 = time.perf_counter()
    raw = cobs_kmer_hashes_batch([encode_seq(r) for r in reads], 31, 1)
    hash_s = time.perf_counter() - t0

    cm = ChunkedMatcher.from_device_index(didx, hbm_budget_mb=args.budget_mb)
    t0 = time.perf_counter()
    hits, nk = cm.score_hits_raw(raw, args.threshold, args.topn)
    score_s = time.perf_counter() - t0
    stats = {}
    try:
        ms = dev.memory_stats()
        stats = {k: ms[k] for k in
                 ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
                 if k in ms}
    except Exception:
        pass
    out = {
        "metric": "real-geometry chunked match (pseudomonas scale)",
        "rows": S, "docs": D, "index_gb": round(nbytes / 1e9, 2),
        "reads": args.reads, "budget_mb": args.budget_mb,
        "gen_s": round(gen_s, 1), "hash_s": round(hash_s, 2),
        "score_s": round(score_s, 1),
        "queries_per_s": round(args.reads / score_s, 1),
        "rows_per_s": round(S / score_s, 1),
        "hits_nonzero": int(sum(1 for h in hits if h)),
        "device_memory_stats": stats,
        "platform": dev.platform,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
