import json

import pytest

from phylign_tpu import testing as fixture_mod
from phylign_tpu.config import Config
from phylign_tpu.io.sam import summary_first3
from phylign_tpu.io.stats import compute_stats
from phylign_tpu.pipeline.stages import Pipeline


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("e2e")
    fixture_mod.make_fixture(d, n_batches=2, seed=7)
    return d


class TestEndToEnd:
    @pytest.fixture(scope="class")
    def run(self, workdir):
        cfg = Config.from_yaml(workdir / "config.yaml")
        pl = Pipeline(cfg, workdir)
        inputs = sorted(str(p) for p in (workdir / "input").iterdir())
        out = pl.run_all(inputs)
        return workdir, pl, out

    def test_golden_columns(self, run):
        workdir, pl, out = run
        got = summary_first3(out)
        want_raw = json.loads((workdir / "data" / "fixture_oracle.json").read_text())
        want = [
            (w[0],) if len(w) == 1 else (str(w[0]), str(w[1]), str(w[2]))
            for w in want_raw
        ]
        assert got == want

    def test_stats(self, run):
        workdir, pl, out = run
        stem = "reads_1___reads_2___reads_3___reads_4"
        st = compute_stats(out, pl.merged_fa(stem))
        assert st.queries == 40
        assert st.cumul_length_bps == 40 * 150
        assert st.nonalignments == 0
        assert st.target_batches == 2
        stats_file = workdir / "output" / f"{stem}.sam_summary.stats"
        assert stats_file.exists()
        assert "aligned_queries" in stats_file.read_text()

    def test_resume_skips_done(self, run):
        workdir, pl, out = run
        stem = "reads_1___reads_2___reads_3___reads_4"
        # all units marked done: a re-run must not recompute (manifest check)
        assert pl.manifest.done("filter", stem)
        for b in pl.batches():
            assert pl.manifest.done("match", f"{b}____{stem}")
            assert pl.manifest.done("map", f"{b}____{stem}")

    def test_benchmark_logs_written(self, run):
        workdir, pl, out = run
        logs = workdir / "logs" / "benchmarks"
        assert (logs / "match_total").exists()
        rows = next((logs / "run_cobs").glob("*.txt")).read_text().splitlines()
        assert rows[0].startswith("real(s)")
        assert len(rows) >= 2

    def test_hbm_accountant_balanced(self, run):
        # index uploads reserve HBM bytes and must all be released after a
        # run; the only standing reservation is the index cache's carve-out
        workdir, pl, out = run
        carved = pl._index_cache.budget if pl._index_cache else 0
        assert pl.sched.hbm.free == pl.sched.hbm.total - carved


class TestGoldenTestEntry:
    def test_run_golden_test(self, tmp_path):
        assert fixture_mod.run_golden_test(tmp_path / "wd")


@pytest.mark.gpu
def test_golden_fixture_on_gpu(gpu, tmp_path):
    assert fixture_mod.run_golden_test(tmp_path)
