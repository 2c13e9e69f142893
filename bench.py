#!/usr/bin/env python3
"""Headline benchmark: match-stage throughput on one GPU.

``--e2e``: instead of the kernel metric, run the WHOLE pipeline (preprocess ->
match -> filter -> align -> aggregate -> stats) twice on synthetic 2-batch
fixtures — first pass warms the persistent compile cache, second pass is
timed — and report end-to-end reads/s. The baseline divisor is the same
pipeline forced onto the CPU backend (XLA-CPU + the same host code), i.e. a
true device-vs-host comparison of this framework, not the reference's
several-hour 661k-batch figure.

Workload: one realistic batch index slice — S = 2M Bloom rows x 68 words
(the exact 2169-doc batch geometry, phylign_tpu.ops.match.pad_device_words
exact-width rows; ~0.5 GB packed), Q = 2048
queries x 128 k-mers — scored by the device match engine (gather + vertical
popcount + threshold). Throughput is measured with the scoring loop inside
one jit (20 reps, scan) so per-call dispatch and fetch amortize out.

Baseline: the reference runs COBS 0.2.1 on CPU (8 I/O-heavy threads,
/root/reference/config.yaml:113). COBS is not installed here, so the CPU
baseline is the same computation in vectorized numpy (gather + popcount via
unpackbits) measured single-threaded and credited x8 for threads — generous
to the CPU since COBS's scalar row loop is no faster than numpy's.

Every printed JSON line carries {"metric", "value", "unit"} and the device it
ran on: ``platform``, ``device_kind``, ``device_count`` and the card's
``power_limit`` (nvidia-smi). Without a GPU the script exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

S, WP, Q, K, REPS = 2_000_000, 68, 2048, 128, 20
CPU_Q = 256  # CPU baseline sample size (scaled up)
CPU_THREADS_CREDIT = 8


def _device_fields() -> dict:
    """The device this process measures on, for every printed line."""
    import jax

    from phylign_tpu.utils.platform import gpu_name_and_power_limit

    dev = jax.devices()[0]
    smi = gpu_name_and_power_limit()
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "power_limit": smi.splitlines()[0].rsplit(",", 1)[-1].strip()
        if smi
        else None,
    }


def _emit(line: dict) -> None:
    print(json.dumps({**line, **_device_fields()}), flush=True)


def match_kernel_throughput() -> float:
    import jax
    import jax.numpy as jnp

    from phylign_tpu.ops.match import match_scores_xla as match_scores

    rng = np.random.default_rng(0)
    block = rng.integers(0, 2**32, (S // 32, WP), dtype=np.uint32)
    words = np.zeros((S + 1, WP), np.uint32)
    words[:S] = np.tile(block, (32, 1))  # content irrelevant to gather cost
    words = jnp.asarray(words)
    idxs = jnp.asarray(rng.integers(0, S, (REPS, Q, K, 1)).astype(np.int32))

    @jax.jit
    def loop(words, idxs):
        def body(c, idx):
            return c + jnp.sum(match_scores(words, idx)), None

        c, _ = jax.lax.scan(body, jnp.int32(0), idxs)
        return c

    float(loop(words, idxs))  # compile + warm
    dt = float("inf")
    for _ in range(2):  # best-of-2 timed passes
        t0 = time.perf_counter()
        float(loop(words, idxs))
        dt = min(dt, time.perf_counter() - t0)
    return REPS * Q / dt


def dedup_main() -> None:
    """--dedup: the cross-query k-mer dedup variant (VERDICT r2 item 4).

    Workload: the standard S=2M/Wp=68/Q=2048/K=128 chunk with 50% of the
    row indices drawn from a small shared pool (overlapping-reads analogue).
    Reports the two-stage dedup kernel's q/s with vs_baseline = speedup over
    the direct big-table gather on the SAME workload; asserts bit-identical
    score sums. Device-only timing (scan-in-jit); the host unique pass is
    excluded."""
    import jax
    import jax.numpy as jnp

    from phylign_tpu.ops.match import dedup_rows, match_scores_xla

    rng = np.random.default_rng(0)
    words_np = np.zeros((S + 1, WP), np.uint32)
    words_np[:S] = rng.integers(0, 2**32, (S, WP), dtype=np.uint32)
    words = jnp.asarray(words_np)

    idxs, unis, invs = [], [], []
    for _ in range(REPS):
        pool = rng.integers(0, S, 4096, dtype=np.int32)
        flat = rng.integers(0, S, Q * K, dtype=np.int32)
        pos = rng.choice(Q * K, Q * K // 2, replace=False)
        flat[pos] = pool[rng.integers(0, len(pool), len(pos))]
        idx = flat.reshape(Q, K)
        dd = dedup_rows(idx, S, WP)
        assert dd is not None, "50%-shared workload must pass the dedup gate"
        idxs.append(idx)
        unis.append(dd[0])
        invs.append(dd[1])
    up = max(u.size for u in unis)
    uni_pad = np.full((REPS, up), S, np.int32)
    for r, u in enumerate(unis):
        uni_pad[r, : u.size] = u

    @jax.jit
    def run_direct(words, idxs):
        def body(c, ix):
            return c + match_scores_xla(words, ix).sum(dtype=jnp.int32), 0

        return jax.lax.scan(body, jnp.int32(0), idxs)[0]

    @jax.jit
    def run_dedup(words, uniqs, invs):
        def body(c, x):
            u, iv = x
            return c + match_scores_xla(words[u], iv).sum(dtype=jnp.int32), 0

        return jax.lax.scan(body, jnp.int32(0), (uniqs, invs))[0]

    i_j = jnp.asarray(np.stack(idxs))
    u_j, v_j = jnp.asarray(uni_pad), jnp.asarray(np.stack(invs))
    a = run_direct(words, i_j)
    int(a)
    b = run_dedup(words, u_j, v_j)
    int(b)
    assert int(a) == int(b), "dedup path diverged from direct scores"
    dt_d = dt_u = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        int(run_direct(words, i_j))
        dt_d = min(dt_d, (time.perf_counter() - t0) / REPS)
        t0 = time.perf_counter()
        int(run_dedup(words, u_j, v_j))
        dt_u = min(dt_u, (time.perf_counter() - t0) / REPS)
    _emit(
        {
            "metric": "match dedup kernel queries/s (50% shared k-mers, 1 GPU)",
            "value": round(Q / dt_u, 1),
            "unit": "queries/s",
            "vs_baseline": round(dt_d / dt_u, 2),
        }
    )


def cpu_baseline_throughput() -> float:
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (S, WP), dtype=np.uint32)
    idx = rng.integers(0, S, (CPU_Q, K)).astype(np.int64)
    times = []
    for _ in range(5):  # median-of-5: this host's cores swing 10-25x rep
        t0 = time.perf_counter()  # to rep (shared/burstable VM)
        g = words[idx.reshape(-1)]  # [CPU_Q*K, WP]
        bits = np.unpackbits(g.view(np.uint8), axis=1)  # [N, WP*32]
        scores = bits.reshape(CPU_Q, K, -1).sum(axis=1, dtype=np.int32)
        _ = scores.max()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    return CPU_Q / med * CPU_THREADS_CREDIT


# e2e fixture scale (VERDICT r2 item 2: >= 16 batches x >= 2k docs and
# >= 10k reads with realistic duplication). Override with --reads/--nbatches.
E2E_BATCHES = 16
E2E_DOCS = 2048
E2E_READS = 10240
E2E_GENOME_LEN = (4_000, 8_000)
E2E_FPR = 0.3  # the real 661k DB's Bloom false-positive regime


def _e2e_arg(argv, flag, default):
    return int(argv[argv.index(flag) + 1]) if flag in argv else default


def _e2e_stage_run(
    workdir, n_batches: int, n_docs: int, n_reads: int,
    seed: int, read_seed: int, reads_only: bool = False,
) -> dict[str, float]:
    """Build (or reuse, reads_only) the perf fixture in ``workdir`` and run
    the pipeline STAGE BY STAGE, returning per-stage seconds plus 'total'.

    seed fixes the DATABASE; read_seed varies the queries — the timed run
    reuses the warm run's database (the production shape: the 305 Zenodo
    batches are fixed across query workloads), so index decode + device
    upload hit the on-disk/device caches exactly as repeated runs do."""
    import shutil

    from phylign_tpu import testing
    from phylign_tpu.config import Config
    from phylign_tpu.pipeline.stages import Pipeline

    testing.make_perf_fixture(
        workdir, n_batches=n_batches, genomes_per_batch=n_docs,
        n_reads=n_reads, seed=seed, read_seed=read_seed,
        genome_len=E2E_GENOME_LEN, fpr=E2E_FPR, reads_only=reads_only,
    )
    for d in ("intermediate", "output"):
        shutil.rmtree(workdir / d, ignore_errors=True)
    cfg = Config.from_yaml(workdir / "config.yaml")
    pl = Pipeline(cfg, workdir)
    inputs = [str(workdir / "input" / "perf_reads.fq")]
    stages: dict[str, float] = {}
    t_all = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        stages[name] = round(time.perf_counter() - t0, 3)
        return out

    stem = timed("preprocess", pl.preprocess, inputs)
    timed("match", pl.match, stem, pl.batches())
    timed("filter", pl.filter, stem)
    timed("align", pl.align, stem, pl.batches())
    timed("aggregate", pl.aggregate, stem)
    timed("stats", pl.stats, stem)
    stages["total"] = round(time.perf_counter() - t_all, 3)
    return stages


def e2e_main() -> None:
    import os
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    n_reads = _e2e_arg(sys.argv, "--reads", E2E_READS)
    n_batches = _e2e_arg(sys.argv, "--nbatches", E2E_BATCHES)
    n_docs = _e2e_arg(sys.argv, "--ndocs", E2E_DOCS)
    if "--cpu-child" in sys.argv:
        # the parent pins JAX_PLATFORMS=cpu, so this process never opens
        # the card the parent holds
        d = Path(tempfile.mkdtemp(prefix="phylign_e2e_cpu_"))
        _e2e_stage_run(d, n_batches, n_docs, n_reads, seed=100, read_seed=100)
        st = _e2e_stage_run(
            d, n_batches, n_docs, n_reads, seed=100, read_seed=101,
            reads_only=True,
        )
        print(f"CPU_STAGES {json.dumps(st)}")
        return
    d = Path(tempfile.mkdtemp(prefix="phylign_e2e_"))
    # warm run: compiles + the one-time database upload
    _e2e_stage_run(d, n_batches, n_docs, n_reads, seed=100, read_seed=100)
    stages = _e2e_stage_run(
        d, n_batches, n_docs, n_reads, seed=100, read_seed=101,
        reads_only=True,
    )
    dt = stages["total"]
    # CPU baseline in a subprocess (backend choice is process-wide)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    child = subprocess.run(
        [
            sys.executable, __file__, "--e2e", "--cpu-child",
            "--reads", str(n_reads), "--nbatches", str(n_batches),
            "--ndocs", str(n_docs),
        ],
        capture_output=True,
        text=True,
        env={**env, "PYTHONPATH": str(Path(__file__).parent)},
        timeout=14400,
    )
    if child.returncode != 0:
        sys.stderr.write(child.stderr[-4000:])
        raise SystemExit(f"CPU baseline child failed ({child.returncode})")
    out = child.stdout
    cpu_stages = json.loads(
        next(l for l in out.splitlines() if l.startswith("CPU_STAGES")).split(
            " ", 1
        )[1]
    )
    _emit(
        {
            "metric": (
                f"end-to-end pipeline reads/s (synthetic "
                f"{n_batches}-batch x {n_docs}-doc fixture, Q={n_reads}, "
                "warm cache)"
            ),
            "value": round(n_reads / dt, 1),
            "unit": "reads/s",
            "vs_baseline": round(cpu_stages["total"] / dt, 2),
            "stages_s": stages,
            "cpu_stages_s": cpu_stages,
        }
    )


def align_pairs_throughput(n_pairs: int = 16384) -> float:
    """Fused align flush pairs/s (the production align kernel path): reads
    sampled from a genome at 1% mismatch, half reverse-complemented, one
    device_pair_chunk-sized pool; best of 3 warm flushes."""
    from phylign_tpu.align import engine as ae
    from phylign_tpu.kmer import decode_seq
    from phylign_tpu.ops import minimizer as opm

    rng = np.random.default_rng(7)
    G, RL = 1_500_000, 150
    params = ae.AlignParams.from_preset("sr")
    genome = rng.integers(0, 4, G).astype(np.uint8)
    ref = opm.build_ref_index("g1", [("c1", genome)], params.k, params.w)
    items = []
    for i in range(n_pairs):
        s = rng.integers(0, G - RL)
        r = genome[s : s + RL].copy()
        nmut = rng.binomial(RL, 0.01)
        pos = rng.choice(RL, nmut, replace=False)
        r[pos] = (r[pos] + rng.integers(1, 4, nmut)) % 4
        if i % 2:
            r = (3 - r)[::-1].copy()
        items.append((f"r{i}", decode_seq(r).decode()))
    sks = ae.QuerySketch.make_batch(items, params)
    tasks = [ae.make_pair(ref, sk, params) for sk in sks]
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        recs = ae.flush_pairs(tasks, params)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    assert sum(1 for r in recs if r.flag != 4) > n_pairs * 0.95
    return n_pairs / best


def main() -> None:
    import os

    kernel = match_kernel_throughput()
    cpu = cpu_baseline_throughput()
    _emit(
        {
            "metric": "match-stage queries/s per batch index "
            "(1 GPU, S=2M, Wp=68, Q=2048, K=128)",
            "value": round(kernel, 1),
            "unit": "queries/s",
            "vs_baseline": round(kernel / cpu, 2),
        }
    )

    if os.environ.get("PHYLIGN_BENCH_ALIGN", "1") != "0":
        _emit(
            {
                "metric": "align-stage pairs/s (fused flush, 16384-pair "
                "pool, 150bp reads @1% mismatch)",
                "value": round(align_pairs_throughput(), 1),
                "unit": "pairs/s",
            }
        )

    if os.environ.get("PHYLIGN_BENCH_E2E", "1") == "0":
        return
    import tempfile
    from pathlib import Path

    nb, nd, nr = E2E_BATCHES, E2E_DOCS, E2E_READS
    d = Path(tempfile.mkdtemp(prefix="phylign_e2e_"))
    _e2e_stage_run(d, nb, nd, nr, seed=100, read_seed=100)  # warm
    stages = _e2e_stage_run(
        d, nb, nd, nr, seed=100, read_seed=101, reads_only=True
    )
    _emit(
        {
            "metric": (
                f"end-to-end pipeline reads/s (synthetic {nb}-batch x "
                f"{nd}-doc fixture, Q={nr}, warm cache)"
            ),
            "value": round(nr / stages["total"], 1),
            "unit": "reads/s",
            "stages_s": stages,
        }
    )


if __name__ == "__main__":
    from phylign_tpu.utils.jaxcache import enable as _enable_jax_cache
    from phylign_tpu.utils.platform import ensure_backend

    # a measurement never falls back to the CPU; only the e2e CPU-baseline
    # child runs there, pinned with JAX_PLATFORMS=cpu by its parent
    try:
        ensure_backend(require_gpu="--cpu-child" not in sys.argv)
    except RuntimeError as e:
        sys.exit(f"bench.py: {e}")
    _enable_jax_cache()
    if "--e2e" in sys.argv:
        e2e_main()
    elif "--dedup" in sys.argv:
        dedup_main()
    else:
        main()
