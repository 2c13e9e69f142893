"""Row-chunked scoring for indexes larger than the device-memory budget.

The largest real batch decompresses to 10.59 GB
(/root/reference/data/decompressed_indexes_sizes.txt); on a device whose
budget is smaller the index cannot sit resident next to the align stage's
device buffers.
ChunkedMatcher streams signature-row blocks through the device and
accumulates scores — these tests pin bit-exactness vs the resident Matcher
and that the pipeline routes oversized indexes through it.
"""

import gzip

import numpy as np
import pytest

from phylign_tpu.io import cobs as iocobs
from phylign_tpu.kmer import cobs_row_indices, encode_seq
from phylign_tpu.models.matcher import ChunkedMatcher, Matcher


def _ascii(rng, n):
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))


@pytest.fixture(scope="module")
def fixture():
    """(device index, doc sequences, reads): half the reads are document
    substrings (dense hits, shared blocks -> ties), half random misses."""
    rng = np.random.default_rng(21)
    docs = []
    shared = _ascii(rng, 400)
    for d in range(70):
        g = _ascii(rng, 3000)
        if d % 7 == 0:
            g = g[:1000] + shared + g[1000:]
        docs.append((f"doc{d:03d}", [g]))
    idx = iocobs.build_classic_index(docs, term_size=31, fpr=0.05)
    didx = iocobs.to_device_index(idx)
    reads = []
    for i in range(40):
        if i % 2:
            reads.append(_ascii(rng, 150))
        else:
            g = docs[i % len(docs)][1][0]
            off = int(rng.integers(0, len(g) - 150))
            reads.append(g[off : off + 150])
    return didx, reads


def _rows(didx, seq):
    return cobs_row_indices(
        encode_seq(seq), didx.term_size, didx.signature_size, didx.num_hashes
    )


def _chunked(didx, row_chunk):
    return ChunkedMatcher(
        term_size=didx.term_size, num_hashes=didx.num_hashes,
        signature_size=didx.signature_size, doc_names=didx.doc_names,
        words_host=np.asarray(didx.words), row_chunk=row_chunk,
    )


class TestChunkedExactness:
    def test_score_rows_bit_exact(self, fixture):
        didx, reads = fixture
        per_q = [_rows(didx, r) for r in reads]
        s1, k1, n1 = Matcher.from_device_index(didx).score_rows(per_q, 0.7)
        # 257: many partial blocks + a ragged last one
        s2, k2, n2 = _chunked(didx, 257).score_rows(per_q, 0.7)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(n1, n2)
        assert k1.any(), "fixture produced no qualifying hits"

    def test_score_hits_identical(self, fixture):
        didx, reads = fixture
        m = Matcher.from_device_index(didx)
        cm = _chunked(didx, 313)
        for thres, topn in ((0.7, 5), (0.3, 3), (0.9, 100)):
            h1, n1 = m.score_hits(reads, thres, topn=topn)
            h2, n2 = cm.score_hits(reads, thres, topn=topn)
            assert h1 == h2, (thres, topn)
            np.testing.assert_array_equal(np.asarray(n1), np.asarray(n2))

    def test_multi_query_pass_split(self, fixture):
        """A tiny accumulator budget forces several query super-passes."""
        didx, reads = fixture
        cm = _chunked(didx, 509)
        cm.acc_budget_bytes = 1  # -> q_pass = 64: splits the 40.. no: min 64
        cm2 = _chunked(didx, 509)
        h1, n1 = cm.score_hits(reads * 4, 0.7, topn=5)  # 160 > 64 per pass
        h2, n2 = cm2.score_hits(reads * 4, 0.7, topn=5)
        assert h1 == h2
        np.testing.assert_array_equal(np.asarray(n1), np.asarray(n2))

    def test_multi_hash_rejected(self, fixture):
        didx, _ = fixture
        with pytest.raises(ValueError, match="num_hashes"):
            _chunked(didx, 64).__class__(
                term_size=didx.term_size, num_hashes=2,
                signature_size=didx.signature_size, doc_names=didx.doc_names,
                words_host=np.asarray(didx.words), row_chunk=64,
            )

    def test_from_device_index_sizing(self, fixture):
        didx, _ = fixture
        cm = ChunkedMatcher.from_device_index(didx, hbm_budget_mb=400)
        assert 1 <= cm.row_chunk <= didx.signature_size


class TestPipelineRouting:
    def test_oversized_index_routes_chunked_and_matches(self, tmp_path):
        """Same fixture, two configs: a normal HBM budget (resident path)
        and a tiny one (forces row-chunked). Match outputs byte-identical."""
        from phylign_tpu import testing as fixture_mod
        from phylign_tpu.config import Config
        from phylign_tpu.pipeline.stages import Pipeline

        outs = []
        for sub, tiny in (("wd", False), ("wd2", True)):
            wd = tmp_path / sub
            fixture_mod.make_fixture(wd, n_batches=1, seed=19)
            cfg = Config.from_yaml(wd / "config.yaml")
            if tiny:
                cfg.device_hbm_gb = 0.001  # ~1 MB: every index "oversized"
                cfg.device_index_cache_gb = 0.0
            pl = Pipeline(cfg, wd)
            inputs = sorted(str(p) for p in (wd / "input").iterdir())
            stem = pl.preprocess(inputs)
            outs.append(pl.match(stem))
        for a, b in zip(*outs):
            assert gzip.open(a, "rb").read() == gzip.open(b, "rb").read()


class TestRatioPreservingGeometry:
    def test_pseudomonas_ratio_multi_chunk_exact(self):
        """Scaled-down REAL geometry (VERDICT r4 item 2): the pseudomonas
        batch is ~39M rows x 2,169 docs = ~18k rows/doc; this test keeps
        that ratio (1.8M rows x 100 docs, ~23 MB packed) and forces the
        stream through >= 8 row blocks, asserting bit-identical hits vs the
        resident matcher. The full-size streamed run on a GPU is
        scripts/dev/real_geometry_rehearsal.py."""
        from phylign_tpu.kmer import cobs_kmer_hashes_batch

        rng = np.random.default_rng(9)
        S, D = 1_800_000, 100
        wp = (D + 31) // 32
        words = rng.integers(0, 1 << 32, size=(S, wp), dtype=np.uint32)
        didx = iocobs.DeviceIndex(
            term_size=31, num_hashes=1, signature_size=S,
            doc_names=[f"r{i}_SAMEA{i:07d}" for i in range(D)], words=words,
        )
        reads = [_ascii(rng, 150) for _ in range(64)]
        raw = cobs_kmer_hashes_batch([encode_seq(r) for r in reads], 31, 1)

        cm = ChunkedMatcher(
            term_size=31, num_hashes=1, signature_size=S,
            doc_names=didx.doc_names, words_host=words,
            row_chunk=S // 8,  # the real batch streams in many blocks
        )
        n_blocks = -(-S // cm.row_chunk)
        assert n_blocks >= 8, (cm.row_chunk, n_blocks)
        got = cm.score_hits_raw(raw, 0.3, 10)

        want = Matcher.from_device_index(didx).score_hits_raw(raw, 0.3, 10)
        assert got[0] == want[0]
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
