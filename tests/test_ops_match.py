import numpy as np
import pytest

import jax.numpy as jnp

from phylign_tpu.io import cobs
from phylign_tpu.kmer import cobs_row_indices, encode_seq
from phylign_tpu.match import oracle
from phylign_tpu.models.matcher import Matcher, match_step
from phylign_tpu.ops import match as opm


def rand_seq(rng, n):
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))


@pytest.fixture(scope="module")
def fixture_index():
    rng = np.random.default_rng(7)
    reads = [rand_seq(rng, 150) for _ in range(12)]
    docs = []
    for d in range(40):  # >32 docs: exercises multi-word rows
        planted = b"".join(reads[i] for i in range(len(reads)) if i % 5 == d % 5)
        docs.append((f"{d:02d}_SAMD{d:05d}", [rand_seq(rng, 400) + planted]))
    idx = cobs.build_classic_index(docs, term_size=31, fpr=0.05)
    return cobs.to_device_index(idx), reads


class TestMatchScoresXLA:
    def test_matches_oracle(self, fixture_index):
        didx, reads = fixture_index
        m = Matcher.from_device_index(didx)
        scores, keep, n_kmers = m.score([r for r in reads], threshold=0.7)
        assert n_kmers[0] == 120
        for i, r in enumerate(reads):
            want, nk = oracle.score_query_codes(didx, encode_seq(r))
            assert nk == n_kmers[i]
            np.testing.assert_array_equal(scores[i], want)
            np.testing.assert_array_equal(keep[i], want >= 0.7 * nk)

    def test_multi_hash(self):
        rng = np.random.default_rng(8)
        seq = rand_seq(rng, 120)
        docs = [("a_X1", [seq]), ("b_X2", [rand_seq(rng, 120)])]
        idx = cobs.build_classic_index(docs, term_size=31, num_hashes=3, fpr=0.01)
        didx = cobs.to_device_index(idx)
        m = Matcher.from_device_index(didx)
        scores, keep, nk = m.score([seq], threshold=0.7)
        want, _ = oracle.score_query_codes(didx, encode_seq(seq))
        np.testing.assert_array_equal(scores[0], want)
        assert scores[0, 0] == 90  # all kmers of the planted doc hit

    def test_short_and_empty_queries(self, fixture_index):
        didx, reads = fixture_index
        m = Matcher.from_device_index(didx)
        scores, keep, nk = m.score([b"ACG", reads[0]], threshold=0.7)
        assert nk[0] == 0
        assert scores[0].sum() == 0
        assert not keep[0].any()  # no kmers -> no hits, not all-hits


def _real_width_case(case):
    """A 2,169-doc index (Wp = 68 words, the real batch width) with random
    bits, plus queries and their packed [Q, K, H] row slots."""
    rng = np.random.default_rng(11)
    d, s, h = 2169, 4096, 2 if case == "two_hashes" else 1
    words = rng.integers(0, 2**32, (s, (d + 31) // 32), dtype=np.uint32)
    didx = cobs.DeviceIndex(
        term_size=31, num_hashes=h, signature_size=s,
        doc_names=[f"r{i}_D{i:05d}" for i in range(d)], words=words,
    )
    q = 13  # not a multiple of any tile size
    lens = [158] * q  # 128 k-mers: K = 128 exactly
    if case == "mixed_lengths":
        lens = [int(x) for x in rng.integers(31, 159, q)]
        lens[0] = 20  # no k-mer at all: every slot is the padding row
    seqs = [rand_seq(rng, n) for n in lens]
    per_query = [
        cobs_row_indices(encode_seq(x), 31, s, h) for x in seqs
    ]
    packed, _ = opm.pack_row_indices(per_query, 128, s, h)
    if case == "all_padding":
        packed[:] = s
    return didx, seqs, packed


REAL_WIDTH_CASES = ["exact_width", "mixed_lengths", "two_hashes", "all_padding"]


@pytest.mark.parametrize("case", REAL_WIDTH_CASES)
def test_xla_matches_oracle_at_real_width(case):
    _check_real_width(case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", REAL_WIDTH_CASES)
def test_xla_matches_oracle_at_real_width_on_gpu(gpu, case):
    _check_real_width(case)  # arrays land on the GPU, JAX's default device


def _check_real_width(case):
    didx, seqs, packed = _real_width_case(case)
    words = jnp.asarray(opm.pad_device_words(didx.words))
    assert words.shape == (didx.signature_size + 1, 68)
    got = np.asarray(opm.match_scores_xla(words, jnp.asarray(packed)))
    assert got.shape == (len(seqs), 68 * 32)
    got = got[:, : didx.num_docs]
    if case == "all_padding":
        assert not got.any()
        return
    for i, seq in enumerate(seqs):
        want, _ = oracle.score_query_codes(didx, encode_seq(seq))
        np.testing.assert_array_equal(got[i], want)


class TestPacking:
    def test_pad_device_words(self):
        w = np.arange(6, dtype=np.uint32).reshape(2, 3)
        p = opm.pad_device_words(w, lane_words=128)
        assert p.shape == (3, 128)
        assert (p[2] == 0).all()
        np.testing.assert_array_equal(p[:2, :3], w)

    def test_pack_row_indices_overflow(self):
        with pytest.raises(ValueError):
            opm.pack_row_indices([np.zeros((5, 1), np.int64)], 3, 99)
