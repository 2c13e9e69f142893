#!/usr/bin/env python3
"""Smoke test of the whole match -> filter -> align pipeline on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py               # one card: phases 1-4 below
    python chip_smoke.py --four-cards  # four cards: the 4x1 mesh path only

One process opens the card; the XLA-CPU reference runs in a child process
pinned to the CPU with JAX_PLATFORMS=cpu, so it never touches the card.

  1. device   the card's name and power limit (nvidia-smi), JAX's devices,
              whether the C++ host library loaded. Fails unless JAX runs on
              a GPU.
  2. golden   `cli fixture` + `cli test`: SAM columns 1-3 equal the fixture's
              constructive oracle.
  3. e2e      16 batches x 2,048 genomes, 10,240 150-bp reads, Bloom FPR 0.3,
              through `cli all` twice (cold, then warm); sam_summary.gz and
              .stats byte-identical to the same pipeline on XLA-CPU.
  4. match    the largest real batch geometry (39M Bloom rows x 2,169 docs,
              10.6 GB) resident through Matcher.from_device_index; 10,240
              reads scored at t=0.7, top-100 + ties; 64 sampled queries equal
              the numpy COBS oracle exactly.

--four-cards runs the phase-3 fixture with mesh_shape 4x1 (doc-sharded
match, all-gather top-k, dp-sharded align) and on one card, in this process,
and requires byte-identical outputs.

Any failed phase makes the script exit non-zero without a result line. The
last line of a passing run is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from phylign_tpu import cli, native, testing
from phylign_tpu.utils import jaxcache
from phylign_tpu.utils.platform import ensure_backend, gpu_name_and_power_limit

REPO = Path(__file__).resolve().parent

# phase 3: the e2e shapes of bench.py (16 batches of the real per-batch
# document count; genomes are 4-8 kb where the real ones are Mb assemblies)
E2E_BATCHES, E2E_DOCS, E2E_READS = 16, 2048, 10240
E2E_GENOME_LEN, E2E_FPR = (4_000, 8_000), 0.3

# phase 4: pseudomonas_aeruginosa__01, the largest real batch index
REAL_ROWS, REAL_DOCS, REAL_READS = 39_000_000, 2169, 10240
ORACLE_SAMPLE = 64

#: pipeline rules (logs/benchmarks/{rule}) that time each stage, in order of
#: preference: the match and align stages log one whole-stage row when they
#: pipeline all batches, and per-batch rows otherwise (mesh runs)
STAGE_RULES = {
    "preprocess": ("fix_query",),
    "match": ("match_pipelined", "run_cobs"),
    "filter": ("translate_matches",),
    "align": ("batch_align_pooled", "batch_align"),
    "aggregate": ("aggregate_sams",),
    "stats": ("final_stats",),
}


class PhaseFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)
    print(f"   ok: {what}", flush=True)


# --- helpers shared by the phases (and tested on the CPU) -------------------


def stage_seconds(workdir: Path) -> dict[str, float]:
    """Seconds of each pipeline stage from logs/benchmarks/{rule}/*.txt
    (the real(s) column, summed over the rule's rows)."""
    out: dict[str, float] = {}
    bench = Path(workdir) / "logs" / "benchmarks"
    for stage, rules in STAGE_RULES.items():
        rule = next((r for r in rules if (bench / r).is_dir()), rules[0])
        total = 0.0
        for f in sorted((bench / rule).glob("*.txt")):
            for line in f.read_text().splitlines()[1:]:
                total += float(line.split("\t")[0])
        out[stage] = round(total, 3)
    return out


def reset_run(workdir: Path) -> None:
    """Forget a finished run (outputs, manifest, logs) but keep the inputs
    and the on-disk caches, so the next run is a warm one."""
    for d in ("intermediate", "output", "logs"):
        shutil.rmtree(Path(workdir) / d, ignore_errors=True)


def make_e2e_fixture(
    workdir: Path, n_batches: int, n_docs: int, n_reads: int, seed: int
) -> None:
    testing.make_perf_fixture(
        workdir, n_batches=n_batches, genomes_per_batch=n_docs,
        n_reads=n_reads, seed=seed, read_seed=seed,
        genome_len=E2E_GENOME_LEN, fpr=E2E_FPR,
    )


def linked_copy(src: Path, dst: Path, config_extra: str = "") -> Path:
    """A second workdir over the same inputs (symlinked), with its own
    config (plus ``config_extra`` lines), caches and outputs."""
    dst.mkdir(parents=True, exist_ok=True)
    for d in ("input", "data", "cobs", "asms"):
        (dst / d).symlink_to((src / d).resolve(), target_is_directory=True)
    (dst / "config.yaml").write_text(
        (src / "config.yaml").read_text() + config_extra
    )
    return dst


def cli_all_args(workdir: Path) -> list[str]:
    return [
        "all", "--workdir", str(workdir),
        "--config", str(workdir / "config.yaml"),
        str(workdir / "input" / "perf_reads.fq"),
    ]


def run_cli_all(workdir: Path) -> float:
    """`phylign-tpu all` in this process; returns its wall seconds."""
    t0 = time.perf_counter()
    cli.main(cli_all_args(workdir))
    return time.perf_counter() - t0


def run_cli_all_on_cpu(workdir: Path, timeout: float = 1800) -> float:
    """`phylign-tpu all` in a child process pinned to XLA-CPU."""
    # no persistent compile cache: XLA:CPU warns on every cached entry it
    # loads, and this run's speed is not measured
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
        JAX_ENABLE_COMPILATION_CACHE="false",
    )
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "phylign_tpu.cli", *cli_all_args(workdir)],
        env=env, capture_output=True, text=True, timeout=timeout,
    )
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise PhaseFailed(f"XLA-CPU reference run exited {proc.returncode}")
    return time.perf_counter() - t0


def output_files(workdir: Path, stem: str = "perf_reads") -> list[Path]:
    out = Path(workdir) / "output"
    return [out / f"{stem}.sam_summary.gz", out / f"{stem}.sam_summary.stats"]


def differing_outputs(a: Path, b: Path, stem: str = "perf_reads") -> list[str]:
    """Names of the output files whose bytes differ between the runs in
    workdirs ``a`` and ``b`` (a missing file differs)."""
    return [
        fa.name
        for fa, fb in zip(output_files(a, stem), output_files(b, stem))
        if not (fa.exists() and fb.exists())
        or fa.read_bytes() != fb.read_bytes()
    ]


def summary_counts(workdir: Path, stem: str = "perf_reads") -> tuple[int, int]:
    """(records, mapped records) of a run's sam_summary."""
    from phylign_tpu.io.sam import read_sam_summary

    n = mapped = 0
    for line in read_sam_summary(output_files(workdir, stem)[0]):
        if line and not line.startswith("==>"):
            n += 1
            mapped += line.split("\t")[1] != "4"
    return n, mapped


def oracle_mismatches(didx, codes, hits, n_keep, threshold, sample) -> list[int]:
    """Queries in ``sample`` whose device hits (all qualifying (doc, score)
    pairs) or qualifying count differ from the numpy COBS oracle."""
    from phylign_tpu.match import oracle

    bad = []
    for q in sample:
        scores, nk = oracle.score_query_codes(didx, codes[q])
        cut = threshold * nk
        docs = np.nonzero(scores >= cut)[0] if nk else np.zeros(0, int)
        want = sorted(((int(d), int(scores[d])) for d in docs),
                      key=lambda t: (-t[1], t[0]))
        got = sorted(((int(d), int(s)) for d, s in hits[q]),
                     key=lambda t: (-t[1], t[0]))
        if got != want or int(n_keep[q]) != len(want):
            bad.append(int(q))
    return bad


def device_peak_gb() -> float:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


class CompileLog:
    """Counts XLA backend compilations and their seconds (JAX's own
    monitoring events) between resets."""

    def __init__(self):
        import jax

        self.n = 0
        self.secs = 0.0

        def on_duration(event: str, secs: float, **_kw) -> None:
            if event == "/jax/core/compile/backend_compile_duration":
                self.n += 1
                self.secs += secs

        jax.monitoring.register_event_duration_secs_listener(on_duration)

    def take(self) -> tuple[int, float]:
        out = (self.n, round(self.secs, 3))
        self.n, self.secs = 0, 0.0
        return out


# --- phases -----------------------------------------------------------------


def phase_device(want_count: int) -> dict:
    import jax

    ensure_backend(require_gpu=True)
    devs = jax.devices()
    dev = devs[0]
    print(f"   jax {jax.__version__}: {devs}", flush=True)
    print(f"   device_kind: {dev.device_kind}", flush=True)
    check(len(devs) >= want_count, f"{len(devs)} device(s), need {want_count}")
    lib = native.get_lib()
    print(f"   native host library loaded: {lib is not None}", flush=True)
    print(f"   compile cache: {jaxcache.enable()}", flush=True)
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(devs)}


def phase_golden(root: Path) -> None:
    wd = root / "golden"
    cli.main(["fixture", "--workdir", str(wd)])
    cli.main(["test", "--workdir", str(wd)])  # exits non-zero on a mismatch


def phase_e2e(root: Path, compiles: CompileLog) -> None:
    wd = root / "e2e"
    print(
        f"   fixture: {E2E_BATCHES} batches x {E2E_DOCS} genomes, "
        f"{E2E_READS} reads of 150 bp, FPR {E2E_FPR}; reduced: genomes are "
        f"{E2E_GENOME_LEN[0] // 1000}-{E2E_GENOME_LEN[1] // 1000} kb where the "
        "real collection has Mb-scale assemblies",
        flush=True,
    )
    t0 = time.perf_counter()
    make_e2e_fixture(wd, E2E_BATCHES, E2E_DOCS, E2E_READS, seed=100)
    print(f"   fixture built in {time.perf_counter() - t0:.1f} s", flush=True)
    cold = root / "e2e_cold"
    for name in ("cold", "warm"):
        if name == "warm":
            shutil.copytree(wd / "output", cold / "output")
            reset_run(wd)
        compiles.take()
        wall = run_cli_all(wd)
        n_comp, comp_s = compiles.take()
        print(
            f"   {name} pass: wall {wall:.3f} s, stages {stage_seconds(wd)}, "
            f"backend compiles {n_comp} ({comp_s} s), "
            f"device peak {device_peak_gb():.2f} GB",
            flush=True,
        )
    cache = jaxcache.cache_dir()
    print(f"   compile cache {cache}: {sum(1 for _ in cache.iterdir())} entries")
    n, mapped = summary_counts(wd)
    check(mapped > E2E_READS // 2, f"{mapped} of {n} SAM records mapped")
    diff = differing_outputs(cold, wd)
    check(not diff, f"warm pass output byte-identical to the cold pass {diff}")
    cpu = linked_copy(wd, root / "e2e_cpu")
    cpu_wall = run_cli_all_on_cpu(cpu)
    print(
        f"   XLA-CPU reference: wall {cpu_wall:.3f} s, stages "
        f"{stage_seconds(cpu)}",
        flush=True,
    )
    diff = differing_outputs(wd, cpu)
    check(not diff, f"sam_summary.gz and .stats byte-identical to XLA-CPU {diff}")


def make_real_geometry_index(rows: int, docs: int, n_reads: int, seed: int):
    """A random Bloom index of the given geometry (bit density 1/2) with
    every read planted: each read's k-mer rows get the bits of one doc, and
    every 97th read's of 150 docs, every 997th read's of 200 docs (ties past
    the top-100 cut and past the device's top-k window).

    Returns (DeviceIndex, read codes, raw k-mer hashes)."""
    from phylign_tpu.io.cobs import DeviceIndex
    from phylign_tpu.kmer import cobs_kmer_hashes_batch

    wp = (docs + 31) // 32
    words = np.empty((rows, wp), np.uint32)
    bitgen = np.random.SFC64(seed)
    step = 1 << 22
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        n = (r1 - r0) * wp
        raw = bitgen.random_raw((n + 1) // 2).view(np.uint32)[:n]
        words[r0:r1] = raw.reshape(r1 - r0, wp)
    if docs % 32:
        words[:, -1] &= np.uint32((1 << (docs % 32)) - 1)  # no phantom docs

    rng = np.random.default_rng(seed)
    codes = [rng.integers(0, 4, 150, dtype=np.uint8) for _ in range(n_reads)]
    raw = cobs_kmer_hashes_batch(codes, 31, 1)
    r_idx, d_idx = [], []
    for q, h in enumerate(raw):
        span = 200 if q % 997 == 0 else 150 if q % 97 == 0 else 1
        rws = (h[:, 0] % np.uint64(rows)).astype(np.int64)
        dd = (q + np.arange(span)) % docs
        r_idx.append(np.repeat(rws, span))
        d_idx.append(np.tile(dd, len(rws)))
    r_all, d_all = np.concatenate(r_idx), np.concatenate(d_idx)
    np.bitwise_or.at(
        words, (r_all, d_all // 32),
        np.left_shift(np.uint32(1), (d_all % 32).astype(np.uint32)),
    )
    didx = DeviceIndex(
        term_size=31, num_hashes=1, signature_size=rows,
        doc_names=[f"r{i:04d}_SAMEA{i:07d}" for i in range(docs)],
        words=words,
    )
    return didx, codes, raw


def phase_match(rows: int, docs: int, n_reads: int) -> None:
    from phylign_tpu.models.matcher import DeviceQueryHashes, Matcher

    t0 = time.perf_counter()
    didx, codes, raw = make_real_geometry_index(rows, docs, n_reads, seed=7)
    gb = didx.words.nbytes / 1e9
    print(
        f"   index {rows} rows x {docs} docs (Wp={didx.num_words}, "
        f"{gb:.2f} GB) built in {time.perf_counter() - t0:.1f} s",
        flush=True,
    )
    t0 = time.perf_counter()
    matcher = Matcher.from_device_index(didx)
    matcher.words.block_until_ready()
    up = time.perf_counter() - t0
    print(f"   resident upload: {up:.3f} s ({gb / up:.2f} GB/s)", flush=True)
    dq = DeviceQueryHashes.build(raw)
    times = []
    for _ in range(2):  # the first call compiles
        t0 = time.perf_counter()
        hits, n_keep = matcher.score_hits_hashes(dq, 0.7, 100)
        times.append(time.perf_counter() - t0)
    qp, kp = dq.hi.shape[:2]
    wp = matcher.words.shape[1]
    moved = qp * kp * wp * 4 + qp * 32 * wp * 4
    print(
        f"   scoring {n_reads} reads (padded Q={qp}, K={kp}): first call "
        f"{times[0]:.3f} s, warm call {times[1]:.3f} s = "
        f"{n_reads / times[1]:.1f} queries/s; {moved / 1e9:.3f} GB gathered "
        f"+ written ({qp}x{kp} rows x {wp * 4} B + {qp}x{32 * wp}x4 B scores)",
        flush=True,
    )
    print(f"   device peak {device_peak_gb():.2f} GB", flush=True)
    many = sum(1 for k in n_keep if k > 100)
    check(
        many >= n_reads // 97,
        f"{many} reads with >100 qualifying docs (top-100 + ties exercised)",
    )
    tied = [0, 97, 997]  # planted in 200 / 150 docs
    rest = np.setdiff1d(np.arange(n_reads), tied)
    sample = tied + np.random.default_rng(1).choice(
        rest, ORACLE_SAMPLE - len(tied), replace=False
    ).tolist()
    bad = oracle_mismatches(didx, codes, hits, n_keep, 0.7, sample)
    check(not bad, f"{len(sample)} sampled queries equal the numpy oracle {bad}")


def phase_four_cards(root: Path) -> None:
    one = root / "mesh_1x1"
    make_e2e_fixture(one, E2E_BATCHES, E2E_DOCS, E2E_READS, seed=100)
    four = linked_copy(one, root / "mesh_4x1", "mesh_shape: 4x1\n")
    for wd in (one, four):
        wall = run_cli_all(wd)
        print(
            f"   {wd.name}: wall {wall:.3f} s, stages {stage_seconds(wd)}, "
            f"device peak {device_peak_gb():.2f} GB",
            flush=True,
        )
    diff = differing_outputs(one, four)
    check(not diff, f"4x1 mesh output byte-identical to one card {diff}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the 4x1 mesh path and its one-card comparison",
    )
    args = ap.parse_args(argv)

    print("== phase device", flush=True)
    smi = gpu_name_and_power_limit()
    if smi:
        print(smi, flush=True)
    try:
        device = phase_device(4 if args.four_cards else 1)
    except (RuntimeError, PhaseFailed) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    compiles = CompileLog()
    root = Path(tempfile.mkdtemp(prefix="phylign_smoke_"))
    if args.four_cards:
        phases = [("four-cards", lambda: phase_four_cards(root))]
    else:
        phases = [
            ("golden", lambda: phase_golden(root)),
            ("e2e", lambda: phase_e2e(root, compiles)),
            ("match", lambda: phase_match(REAL_ROWS, REAL_DOCS, REAL_READS)),
        ]
    failed = []
    try:
        for name, fn in phases:
            print(f"== phase {name}", flush=True)
            t0 = time.perf_counter()
            try:
                fn()
            except (Exception, SystemExit) as e:  # report, run the rest, fail
                traceback.print_exc()
                print(f"== phase {name}: FAILED: {e}", flush=True)
                failed.append(name)
                continue
            print(
                f"== phase {name}: passed in {time.perf_counter() - t0:.1f} s",
                flush=True,
            )
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
