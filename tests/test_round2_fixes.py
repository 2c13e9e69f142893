"""Round-2 hardening: config-knob honesty, parallel downloads, cluster
precheck, byte-exact banners, COBS header diagnostics, filter tolerance."""

import gzip
import http.server
import json
import logging
import threading

import numpy as np
import pytest

from phylign_tpu import testing as fixture_mod
from phylign_tpu.config import Config
from phylign_tpu.io.fastx import FastxRecord
from phylign_tpu.pipeline.stages import Pipeline


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("r2fix")
    fixture_mod.make_fixture(d, n_batches=1, seed=7)
    return d


class TestConfigKnobs:
    def test_inert_keys_warn(self, caplog):
        with caplog.at_level(logging.WARNING, logger="phylign_tpu.config"):
            Config.from_dict(
                {"cobs_threads": 4, "minimap_threads": 2, "prefer_pipe": False}
            )
        text = caplog.text
        for key in ("cobs_threads", "minimap_threads", "prefer_pipe"):
            assert key in text and "no effect" in text

    def test_silent_when_absent(self, caplog):
        with caplog.at_level(logging.WARNING, logger="phylign_tpu.config"):
            Config.from_dict({"nb_best_hits": 5})
        assert "no effect" not in caplog.text

    def test_reference_config_still_loads(self, caplog):
        from phylign_tpu.config import load_flat_yaml

        with open("/root/reference/config.yaml") as f:
            ref = load_flat_yaml(f.read())
        with caplog.at_level(logging.WARNING, logger="phylign_tpu.config"):
            cfg = Config.from_dict(ref)
        assert cfg.nb_best_hits == ref["nb_best_hits"]

    def test_keep_cobs_indexes_false_drops_cache(self, workdir):
        cfg = Config.from_yaml(workdir / "config.yaml").with_overrides(
            index_load_mode="mem-disk", keep_cobs_indexes=False
        )
        pl = Pipeline(cfg, workdir)
        batch = pl.batches()[0]
        stem = pl.preprocess(
            sorted(str(p) for p in (workdir / "input").iterdir())
        )
        pl.match_one_batch(batch, stem)
        assert not (pl._decompression_dir() / batch).exists()

    def test_keep_cobs_indexes_true_keeps_cache(self, workdir, tmp_path):
        cfg = Config.from_yaml(workdir / "config.yaml").with_overrides(
            index_load_mode="mem-disk",
            keep_cobs_indexes=True,
            intermediate_dir=str(tmp_path / "inter2"),
        )
        pl = Pipeline(cfg, workdir)
        batch = pl.batches()[0]
        stem = pl.preprocess(
            sorted(str(p) for p in (workdir / "input").iterdir())
        )
        pl.match_one_batch(batch, stem)
        assert (pl._decompression_dir() / batch / "meta.json").exists()


class TestParallelDownload:
    @pytest.fixture()
    def stub_server(self, tmp_path):
        """Local HTTP server serving tiny valid-xz payloads for any path."""
        import lzma
        import os as _os

        payload = lzma.compress(_os.urandom(200_000))  # incompressible: >100 kB
        hits = []

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                hits.append(self.path)
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        yield f"http://127.0.0.1:{srv.server_address[1]}", hits
        srv.shutdown()

    def test_download_batches_parallel(self, stub_server, tmp_path, monkeypatch):
        from phylign_tpu.pipeline import download as dl

        base, hits = stub_server
        monkeypatch.setattr(dl, "cobs_url", lambda b: f"{base}/cobs/{b}.xz")
        monkeypatch.setattr(dl, "asms_url", lambda b: f"{base}/asms/{b}.xz")
        batches = [f"b{i:02d}__01" for i in range(6)]
        status = dl.download_batches(
            batches, tmp_path, retries=0, retry_wait=0, max_threads=4
        )
        assert all(v == "downloaded (cobs+asms)" for v in status.values())
        assert len(hits) == 12
        for b in batches:
            assert (tmp_path / "cobs" / f"{b}.cobs_classic.xz").exists()
            assert (tmp_path / "asms" / f"{b}.tar.xz").exists()
        # second call: everything present, no new requests
        status2 = dl.download_batches(
            batches, tmp_path, retries=0, retry_wait=0, max_threads=4
        )
        assert all(v == "already present" for v in status2.values())
        assert len(hits) == 12

    def test_download_failure_collected(self, tmp_path, monkeypatch):
        from phylign_tpu.pipeline import download as dl

        monkeypatch.setattr(
            dl, "cobs_url", lambda b: "http://127.0.0.1:1/none.xz"
        )
        with pytest.raises(RuntimeError, match="download"):
            dl.download_batches(
                ["x__01"], tmp_path, retries=0, retry_wait=0, only="cobs"
            )


class TestClusterPrecheck:
    def test_auto_threads_rejected(self):
        from phylign_tpu.parallel.launch import check_cluster_config

        with pytest.raises(ValueError, match="cobs_threads"):
            check_cluster_config(Config(cobs_threads="auto", threads=4))
        with pytest.raises(ValueError, match="threads"):
            check_cluster_config(Config(cobs_threads=4, threads="all"))

    def test_fixed_ints_pass(self):
        from phylign_tpu.parallel.launch import check_cluster_config

        check_cluster_config(Config(cobs_threads=4, threads=8))

    def test_cli_exit_code(self, tmp_path, capsys):
        from phylign_tpu.cli import main

        (tmp_path / "config.yaml").write_text("cobs_threads: auto\n")
        with pytest.raises(SystemExit):
            main(["check-cluster", "--workdir", str(tmp_path)])
        (tmp_path / "config.yaml").write_text("cobs_threads: 4\nthreads: 2\n")
        main(["check-cluster", "--workdir", str(tmp_path)])
        assert "OK" in capsys.readouterr().out


class TestBannerBytes:
    def test_workdir_relative_banners(self, tmp_path):
        from phylign_tpu.io.sam import aggregate_sams

        a = tmp_path / "a.sam.gz"
        b = tmp_path / "b.sam.gz"
        for p in (a, b):
            with gzip.open(p, "wt") as f:
                f.write(f"q1\t0\t{p.stem}\n")
        out = tmp_path / "sum.gz"
        aggregate_sams(
            out,
            [a, b],
            banners=[
                "intermediate/05_map/batch_a____q.sam.gz",
                "intermediate/05_map/batch_b____q.sam.gz",
            ],
        )
        text = gzip.decompress(out.read_bytes()).decode()
        # byte-exact reference banner contract (aggregate_sams.sh:13-24):
        # first banner has no leading newline, later ones do
        assert text.startswith("==> intermediate/05_map/batch_a____q.sam.gz <==\n")
        assert "\n==> intermediate/05_map/batch_b____q.sam.gz <==\n" in text
        assert str(tmp_path) not in text

    def test_pipeline_emits_relative_banners(self, workdir):
        cfg = Config.from_yaml(workdir / "config.yaml")
        pl = Pipeline(cfg, workdir)
        stem = pl.preprocess(
            sorted(str(p) for p in (workdir / "input").iterdir())
        )
        batch = pl.batches()[0]
        # reuse any existing 05_map output or create a stub
        mp = pl.map_path(batch, stem)
        if not mp.exists():
            with gzip.open(mp, "wt") as f:
                f.write("q\t4\t*\n")
        out = pl.aggregate(stem)
        text = gzip.decompress(out.read_bytes()).decode()
        assert text.startswith(f"==> intermediate/05_map/{batch}____{stem}.sam.gz <==\n")


class TestCobsHardening:
    def _tiny_index_bytes(self):
        from phylign_tpu.io import cobs as cobs_io

        idx = cobs_io.build_classic_index(
            [("0001_SAMX", [b"ACGTACGTACGTACGTACGTACGTACGTACGTACGT"])],
            term_size=31,
        )
        import io as _io

        buf = _io.BytesIO()
        cobs_io._write_header(buf, idx)
        buf.write(idx.rows.tobytes())
        return buf.getvalue()

    def test_inspect_ok(self, tmp_path):
        from phylign_tpu.io import cobs as cobs_io

        idx = cobs_io.build_classic_index(
            [("0001_SAMX", [b"ACGTACGTACGTACGTACGTACGTACGTACGTACGT"])],
            term_size=31,
        )
        p = tmp_path / "t.cobs_classic"
        cobs_io.write_classic_index(p, idx)
        rep = cobs_io.inspect_classic_index(p)
        assert rep["ok"] and rep["term_size"] == 31 and rep["num_docs"] == 1
        assert rep["payload_bytes_expected"] == rep["payload_bytes_actual"]
        assert rep["doc_names_rid_prefixed"]

    def test_bad_field_named(self, tmp_path):
        from phylign_tpu.io import cobs as cobs_io

        raw = bytearray(self._tiny_index_bytes())
        # corrupt term_size (bytes 22..26 after 18-byte magic + u32 version)
        raw[22:26] = (999).to_bytes(4, "little")
        p = tmp_path / "bad.cobs_classic"
        p.write_bytes(raw)
        with pytest.raises(cobs_io.CobsFormatError, match="term_size"):
            cobs_io.read_classic_index(p)
        rep = cobs_io.inspect_classic_index(p)
        assert not rep["ok"] and "term_size" in rep["error"]

    def test_payload_mismatch_named(self, tmp_path):
        from phylign_tpu.io import cobs as cobs_io

        raw = self._tiny_index_bytes()
        p = tmp_path / "short.cobs_classic"
        p.write_bytes(raw[:-5])
        with pytest.raises(cobs_io.CobsFormatError, match="payload size"):
            cobs_io.read_classic_index(p)
        p2 = tmp_path / "long.cobs_classic"
        p2.write_bytes(raw + b"xx")
        with pytest.raises(cobs_io.CobsFormatError, match="payload size"):
            cobs_io.read_classic_index(p2)

    def test_bad_magic_named(self, tmp_path):
        from phylign_tpu.io import cobs as cobs_io

        p = tmp_path / "junk.cobs_classic"
        p.write_bytes(b"NOT_AN_INDEX" + b"\0" * 64)
        with pytest.raises(cobs_io.CobsFormatError, match="magic"):
            cobs_io.read_classic_index(p)


class TestFilterTolerance:
    def test_arrays_path_tolerates_unknown_query(self):
        native = pytest.importorskip("phylign_tpu.native")
        if native.get_lib() is None:
            pytest.skip("native lib unavailable")
        from phylign_tpu.match.filter import filter_queries_arrays

        text = b"*known\t5\n_ACC1\t100\n*ghost\t3\n_ACC2\t50\n"
        parsed = {"batch_a": native.native_parse_match_text(text)}
        out = filter_queries_arrays(
            [FastxRecord("known", "", "ACGT")], parsed, keep=10
        )
        names = {q.qname: q for q in out}
        assert names["known"].candidates == [("batch_a", "ACC1", 100)]
        assert names["ghost"].seq == ""
        assert names["ghost"].candidates == [("batch_a", "ACC2", 50)]


class TestNativeParseBounds:
    def test_overflow_score_rejected(self):
        native = pytest.importorskip("phylign_tpu.native")
        if native.get_lib() is None:
            pytest.skip("native lib unavailable")
        # 19+ digits: parse must fail cleanly (numpy fallback), not overflow
        for bad in (b"*q\t99999999999999999999\n",
                    b"*q\t2\n_A\t99999999999999999999\n",
                    b"*q\t2\n_A\t4294967296\n"):
            with pytest.raises(ValueError):
                native.native_parse_match_text(bad)

    def test_max_int32_score_ok(self):
        native = pytest.importorskip("phylign_tpu.native")
        if native.get_lib() is None:
            pytest.skip("native lib unavailable")
        pm = native.native_parse_match_text(b"*q\t1\n_A\t2147483647\n")
        assert pm.score[0] == 2147483647


class TestDeviceIndexCache:
    """VERDICT round-1 item 10: content-hash device index cache — a second
    match pass over the same batch must skip the Matcher rebuild/upload."""

    def test_second_match_run_hits_cache(self, tmp_path):
        from phylign_tpu import testing as fixture_mod
        from phylign_tpu.config import Config
        from phylign_tpu.pipeline.stages import Pipeline

        wd = tmp_path / "wd"
        fixture_mod.make_fixture(wd, n_batches=1, seed=11)
        cfg = Config.from_yaml(wd / "config.yaml")
        pl = Pipeline(cfg, wd)
        inputs = sorted(str(p) for p in (wd / "input").iterdir())
        stem = pl.preprocess(inputs)
        pl.match(stem)
        assert pl._index_cache is not None
        misses0 = pl._index_cache.misses
        assert misses0 >= 1
        # force recompute: clear manifest + outputs, re-match
        pl.manifest.clear("match")
        for b in pl.batches():
            mf = pl.inter / "03_match" / f"{b}____{stem}.gz"
            if mf.exists():
                mf.unlink()
        pl.match(stem)
        assert pl._index_cache.hits >= 1
        assert pl._index_cache.misses == misses0  # no new uploads

    def test_cache_disabled_by_config(self, tmp_path):
        from phylign_tpu.config import Config
        from phylign_tpu.pipeline.stages import Pipeline

        cfg = Config(device_index_cache_gb=0.0)
        pl = Pipeline(cfg, tmp_path / "wd2")
        assert pl._index_cache is None
        assert pl.sched.hbm.free == pl.sched.hbm.total
