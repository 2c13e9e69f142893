"""Runtime setup for the GPU: backend choice, compile cache, device-memory
budget, the flat YAML config format, psutil-free run logs, and the helpers
of chip_smoke.py (exercised at a tiny size on XLA-CPU)."""

import dataclasses
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from phylign_tpu import testing
from phylign_tpu.config import Config, dump_flat_yaml, load_flat_yaml
from phylign_tpu.pipeline.scheduler import Scheduler
from phylign_tpu.utils import jaxcache
from phylign_tpu.utils.bench import RamSampler, used_ram_kb
from phylign_tpu.utils.platform import ensure_backend

REPO = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- compile cache -----------------------------------------------------------


@pytest.fixture
def restore_cache_config():
    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_entry_size_bytes",
        "jax_persistent_cache_min_compile_time_secs",
    )
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_jaxcache_honours_env_dir(monkeypatch, tmp_path, restore_cache_config):
    target = tmp_path / "cc"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert jaxcache.enable() == target
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert target.is_dir()


def test_jaxcache_default_is_fixed_ignored_checkout_dir(
    monkeypatch, restore_cache_config
):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcache.cache_dir() == REPO / ".jax_cache"
    assert jaxcache.enable() == REPO / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    assert "/.jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


# --- backend choice ----------------------------------------------------------


@pytest.fixture
def unpinned_platforms():
    old = jax.config.jax_platforms
    jax.config.update("jax_platforms", "")
    yield
    jax.config.update("jax_platforms", old)


def test_ensure_backend_refuses_silent_cpu_fallback(unpinned_platforms):
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        ensure_backend()


def test_ensure_backend_pinned_cpu(monkeypatch):
    assert ensure_backend() == "cpu"
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        ensure_backend(require_gpu=True)


@pytest.mark.parametrize(
    "argv, pin_cpu",
    [
        (["-m", "phylign_tpu.cli", "all", "--workdir", "{tmp}"], False),
        (["bench.py"], False),
        (["chip_smoke.py"], True),  # a pinned CPU is no GPU either
    ],
    ids=["cli-all", "bench", "chip_smoke"],
)
def test_entry_points_exit_nonzero_without_gpu(tmp_path, argv, pin_cpu):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    if pin_cpu:
        env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, *[a.format(tmp=tmp_path) for a in argv]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_pin_local_card_takes_process_id_modulo_cards(
    monkeypatch, unpinned_platforms
):
    from phylign_tpu.utils.platform import local_gpu_count, pin_local_card

    old = jax.config.read("jax_cuda_visible_devices")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    assert local_gpu_count() == 4
    try:
        assert pin_local_card(5) == 1
        assert jax.config.read("jax_cuda_visible_devices") == "1"
    finally:
        jax.config.update("jax_cuda_visible_devices", old)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert pin_local_card(5) is None  # no card: nothing to pin


def test_pin_local_card_leaves_pinned_cpu_alone(monkeypatch):
    from phylign_tpu.utils.platform import pin_local_card

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    assert pin_local_card(1) is None


# --- device-memory budget ----------------------------------------------------


class _FakeDevice:
    platform = "gpu"

    def memory_stats(self):
        return {"bytes_limit": 60 << 30, "bytes_in_use": 0}


def test_device_budget_auto_reads_memory_stats(monkeypatch):
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_FakeDevice()])
    assert Config().device_hbm_gb == "auto"
    assert Config().device_budget_mb() == 60 * 1024
    sched = Scheduler(workers=1, max_ram_mb=64, max_io_heavy=1)
    assert sched.hbm.total == 60 * 1024
    # an explicit number in the config still wins
    assert Config(device_hbm_gb=2).device_budget_mb() == 2048


def test_device_budget_cpu_and_validation():
    # XLA-CPU has no memory stats: the budget is the host's memory
    host_mb = (os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")) >> 20
    assert Config().device_budget_mb() == host_mb
    with pytest.raises(ValueError, match="device_hbm_gb"):
        Config.from_dict({"device_hbm_gb": "lots"})


# --- flat YAML config --------------------------------------------------------


@pytest.mark.parametrize("maker", ["make_fixture", "make_perf_fixture"])
def test_flat_yaml_round_trips_fixture_config(tmp_path, maker):
    kw = {} if maker == "make_fixture" else {
        "n_batches": 1, "genomes_per_batch": 4, "n_reads": 8,
    }
    getattr(testing, maker)(tmp_path, **kw)
    text = (tmp_path / "config.yaml").read_text()
    data = load_flat_yaml(text)
    assert data and all(not isinstance(v, dict) for v in data.values())
    assert load_flat_yaml(dump_flat_yaml(data)) == data
    cfg = Config.from_yaml(tmp_path / "config.yaml")
    full = dataclasses.asdict(cfg)
    assert load_flat_yaml(dump_flat_yaml(full)) == full


def test_flat_yaml_scalars():
    text = (
        "---\n# reference-style comments\n"
        'batches: "data/batches_small.txt"  # quoted\n'
        "cobs_kmer_thres: 0.7\nnb_best_hits: 100\nprefer_pipe: True\n"
        "decompression_dir: null\nthreads: all\nname: 'it''s'\n"
        "empty:\nexp: 1e-3\n"
    )
    assert load_flat_yaml(text) == {
        "batches": "data/batches_small.txt", "cobs_kmer_thres": 0.7,
        "nb_best_hits": 100, "prefer_pipe": True, "decompression_dir": None,
        "threads": "all", "name": "it's", "empty": None, "exp": 0.001,
    }


@pytest.mark.parametrize(
    "text",
    [
        "mesh:\n  d: 4\n",
        "- a\n- b\n",
        "presets: [sr, map-ont]\n",
        "limits: {ram: 12}\n",
        "a: b: c\n",
        "a: 1\na: 2\n",
        "text: |\n",
    ],
    ids=["nested", "list", "flow-list", "flow-map", "colon", "dup", "block"],
)
def test_flat_yaml_rejects_non_flat(text):
    with pytest.raises(ValueError):
        load_flat_yaml(text)


# --- run logs without psutil -------------------------------------------------


def test_ram_sampler_reads_proc_meminfo(tmp_path):
    fake = tmp_path / "meminfo"
    fake.write_text(
        "MemTotal:       1000 kB\nMemFree:         100 kB\n"
        "MemAvailable:    300 kB\n"
    )
    assert used_ram_kb(fake) == 700
    with RamSampler(interval=0.01) as r:
        block = np.ones(32 << 20, np.uint8)  # touch 32 MB
        time.sleep(0.1)
    assert r.baseline_kb > 0 and r.max_delta_kb >= 0
    del block


def test_no_module_needs_yaml_or_psutil():
    code = (
        "import sys, importlib, pathlib\n"
        "sys.modules['yaml'] = None\nsys.modules['psutil'] = None\n"
        "root = pathlib.Path('phylign_tpu')\n"
        "for p in sorted(root.rglob('*.py')):\n"
        "    importlib.import_module('.'.join(p.with_suffix('').parts)"
        ".removesuffix('.__init__'))\n"
        "print('imported')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "imported" in proc.stdout


# --- chip_smoke.py helpers, tiny and on the CPU ------------------------------


def test_chip_smoke_e2e_comparison(tmp_path):
    cs = _load_chip_smoke()
    wd = tmp_path / "gpu_side"
    cs.make_e2e_fixture(wd, n_batches=2, n_docs=24, n_reads=96, seed=3)
    cs.run_cli_all(wd)
    st = cs.stage_seconds(wd)
    assert set(st) == set(cs.STAGE_RULES) and st["match"] > 0 and st["align"] > 0
    n, mapped = cs.summary_counts(wd)
    assert n == 96 and mapped > 48
    ref = cs.linked_copy(wd, tmp_path / "cpu_side")
    cs.run_cli_all_on_cpu(ref, timeout=600)
    assert cs.differing_outputs(wd, ref) == []
    stats = cs.output_files(ref)[1]
    stats.write_bytes(stats.read_bytes() + b"x")
    assert cs.differing_outputs(wd, ref) == [stats.name]


def test_chip_smoke_real_geometry_oracle():
    from phylign_tpu.models.matcher import DeviceQueryHashes, Matcher

    cs = _load_chip_smoke()
    didx, codes, raw = cs.make_real_geometry_index(
        rows=20_000, docs=300, n_reads=200, seed=5
    )
    assert didx.num_words == 10 and not (didx.words[:, -1] >> 12).any()
    hits, n_keep = Matcher.from_device_index(didx).score_hits_hashes(
        DeviceQueryHashes.build(raw), 0.7, 100
    )
    assert int(n_keep[0]) >= 200 and int(n_keep[97]) >= 150
    sample = list(range(0, 200, 7)) + [97]
    assert cs.oracle_mismatches(didx, codes, hits, n_keep, 0.7, sample) == []
    hits[7] = hits[7][1:]  # a lost hit must be caught
    assert cs.oracle_mismatches(didx, codes, hits, n_keep, 0.7, sample) == [7]
