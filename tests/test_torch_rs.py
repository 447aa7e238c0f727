"""ops/rs.py and ops/gf256.py of the port against the JAX package's:
RSCode and RSStream give the same bytes as cess_tpu's RSCode/RSStream
and as gf256's numpy references, on both GF(256) products — plain and
streamed, every RS(2,1) erasure pattern, grouped per-segment recovery —
and refuse the same bad input.  The cases mirror tests/test_rs.py and
tests/test_rs_hotpath.py at their shapes; the tolerance is exact bytes."""

import itertools
import warnings

import numpy as np
import pytest
import torch

from cess_tpu.ops import gf256 as jgf
from cess_tpu.ops import rs as jrs
from cess_tpu_torch.ops import gf256, rs

# The twins run many tiny ops: with several test workers on one host,
# intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

PATHS = ("bitplane", "gather")
RS21_PATTERNS = ([0, 1], [0, 2], [1, 2])  # every 2-of-3 survivor set


def _code(k, m, path, **kw):
    return rs.RSCode(k, m, path=path, device="cpu", **kw)


def _roundtrip_case(k, m, n, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(k, n), dtype=np.uint8)
    parity = gf256.rs_encode_ref(data, k, m)
    return data, np.concatenate([data, parity], axis=0)


def _mixed_batch(k, m, b, n, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(b, k, n), dtype=np.uint8)
    allsh = np.stack(
        [np.concatenate([d, gf256.rs_encode_ref(d, k, m)]) for d in data]
    )
    pats = [sorted(rng.choice(k + m, size=k, replace=False).tolist()) for _ in range(b)]
    surv = np.stack([allsh[i, pats[i]] for i in range(b)])
    return data, pats, surv


# ------------------------------------------------------------- gf256 copy


@pytest.mark.parametrize("k,m", [(2, 1), (12, 4), (5, 3)])
def test_gf256_copy_matches_jax_package(k, m):
    assert gf256.PRIM_POLY == jgf.PRIM_POLY and gf256.FIELD == jgf.FIELD
    for name in ("EXP", "LOG", "MUL_TABLE", "INV"):
        np.testing.assert_array_equal(getattr(gf256, name), getattr(jgf, name))
    for fn in ("cauchy_matrix", "encode_matrix"):
        np.testing.assert_array_equal(getattr(gf256, fn)(k, m), getattr(jgf, fn)(k, m))
    gen = gf256.encode_matrix(k, m)
    np.testing.assert_array_equal(gf256.bit_matrix(gen), jgf.bit_matrix(gen))
    rows = list(range(m, m + k))
    np.testing.assert_array_equal(gf256.mat_inv(gen[rows]), jgf.mat_inv(gen[rows]))
    data, allsh = _roundtrip_case(k, m, 257, seed=k)
    np.testing.assert_array_equal(gf256.rs_encode_ref(data, k, m), jgf.rs_encode_ref(data, k, m))
    np.testing.assert_array_equal(
        gf256.rs_decode_ref(allsh[rows], rows, k, m), jgf.rs_decode_ref(allsh[rows], rows, k, m)
    )
    assert gf256.gf_pow(3, 2**28) == jgf.gf_pow(3, 2**28)
    assert all(gf256.gf_mul(a, gf256.gf_inv(a)) == 1 for a in range(1, 256))


def test_gf256_any_k_rows_of_the_generator_invert():
    k, m = 4, 3
    gen = gf256.encode_matrix(k, m)
    for rows in itertools.combinations(range(k + m), k):
        sub = gen[list(rows)]
        np.testing.assert_array_equal(
            gf256.mat_mul(sub, gf256.mat_inv(sub)), np.eye(k, dtype=np.uint8)
        )


# ------------------------------------------------------------ bit identity


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("k,m", [(2, 1), (12, 4)])
@pytest.mark.parametrize("n", [16, 100, 1021, 4096])
def test_encode_matches_jax_and_reference(path, k, m, n):
    data, _ = _roundtrip_case(k, m, n, seed=n)
    got = _code(k, m, path).encode(data)
    assert got.dtype == torch.uint8 and got.shape == (m, n)
    want = np.asarray(jrs.RSCode(k, m, path=path).encode(data))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), gf256.rs_encode_ref(data, k, m))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("present", RS21_PATTERNS)
def test_rs21_every_erasure_pattern(path, present):
    data, allsh = _roundtrip_case(2, 1, 777, seed=3)
    got = _code(2, 1, path).reconstruct(allsh[present], present).numpy()
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, gf256.rs_decode_ref(allsh[present], present, 2, 1))
    want = np.asarray(jrs.RSCode(2, 1, path=path).reconstruct(allsh[present], present))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", PATHS)
def test_rs124_random_patterns(path):
    rng = np.random.default_rng(7)
    data, allsh = _roundtrip_case(12, 4, 250, seed=9)
    code, jcode = _code(12, 4, path), jrs.RSCode(12, 4, path=path)
    for _ in range(5):
        present = sorted(rng.choice(16, size=12, replace=False).tolist())
        got = code.reconstruct(allsh[present], present).numpy()
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(got, np.asarray(jcode.reconstruct(allsh[present], present)))


@pytest.mark.parametrize("path", PATHS)
def test_batches_match_jax(path):
    rng = np.random.default_rng(5)
    k, m, n, b = 4, 2, 128, 6
    data = rng.integers(0, 256, (b, k, n)).astype(np.uint8)
    code = _code(k, m, path)
    par = code.encode_batch(data).numpy()
    np.testing.assert_array_equal(par, np.asarray(jrs.RSCode(k, m, path=path).encode_batch(data)))
    for i in range(b):
        np.testing.assert_array_equal(par[i], gf256.rs_encode_ref(data[i], k, m))
    # one shared survivor list: a tensor back, equal to the data
    surv = np.concatenate([data[:, 2:], par], axis=1)
    got = code.reconstruct_batch(surv, [2, 3, 4, 5])
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), data)


@pytest.mark.parametrize("path", PATHS)
def test_uint8_bytes_index_as_a_gather_not_a_mask(path):
    """256 data bytes, the table's own length, all nonzero: as a uint8
    index tensor they would be a boolean mask that selects the whole
    table row and raises nothing.  The products must gather instead."""
    rng = np.random.default_rng(256)
    data = rng.integers(1, 256, size=(2, 256), dtype=np.uint8)
    row = torch.as_tensor(gf256.MUL_TABLE[7])
    with warnings.catch_warnings():  # torch deprecates uint8 masks
        warnings.simplefilter("ignore")
        masked = row[torch.as_tensor(data[0])]
    assert masked.shape == (256,) and torch.equal(masked, row)  # the trap
    code = _code(2, 1, path)
    np.testing.assert_array_equal(code.encode(data).numpy(), gf256.rs_encode_ref(data, 2, 1))
    allsh = np.concatenate([data, gf256.rs_encode_ref(data, 2, 1)])
    np.testing.assert_array_equal(code.reconstruct(allsh[[1, 2]], [1, 2]).numpy(), data)


@pytest.mark.parametrize("path", PATHS)
def test_products_walk_the_byte_axis_in_steps(path, monkeypatch):
    """With a small temporary budget each product takes many steps (a
    ragged last one) over the byte axis; the bytes do not change."""
    monkeypatch.setattr(rs, "TEMP_BYTES", 1000)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=(3, 12, 1001), dtype=np.uint8)
    got = _code(12, 4, path).encode_batch(data).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], gf256.rs_encode_ref(data[i], 12, 4))


# ----------------------------------------------------------------- streams


@pytest.mark.parametrize("path", PATHS)
def test_stream_encode_odd_tail(path):
    # 4096-byte tiles over a 3.3-tile stream
    data, _ = _roundtrip_case(2, 1, 13_500, seed=5)
    stages = {}
    got = rs.RSStream(_code(2, 1, path, tile=4096), stages=stages).run(data)
    np.testing.assert_array_equal(got, gf256.rs_encode_ref(data, 2, 1))
    want = jrs.RSStream(jrs.RSCode(2, 1, path=path, tile=4096)).run(data)
    np.testing.assert_array_equal(got, want)
    assert set(stages) == set(rs.RS_STAGE_NAMES)
    assert all(v >= 0.0 for v in stages.values())


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("present", RS21_PATTERNS)
def test_stream_reconstruct_every_pattern(path, present):
    data, allsh = _roundtrip_case(2, 1, 10_000, seed=6)
    got = rs.RSStream(_code(2, 1, path, tile=4096), present=present).run(allsh[present])
    np.testing.assert_array_equal(got, data)
    want = jrs.RSStream(jrs.RSCode(2, 1, path=path, tile=4096), present=present).run(allsh[present])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", PATHS)
def test_stream_rs124(path):
    data, allsh = _roundtrip_case(12, 4, 9_001, seed=8)
    present = [0, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15]
    got = rs.RSStream(_code(12, 4, path, tile=2048), present=present).run(allsh[present])
    np.testing.assert_array_equal(got, gf256.rs_decode_ref(allsh[present], present, 12, 4))
    np.testing.assert_array_equal(got, data)


def test_stream_encode_rejects_extra_rows():
    bad = np.zeros((3, 64), dtype=np.uint8)
    with pytest.raises(ValueError, match="exactly 2 data rows"):
        rs.RSStream(_code(2, 1, "gather")).run(bad)
    with pytest.raises(ValueError, match="exactly 2 data rows"):
        rs.RSStream(_code(2, 1, "gather")).run_batch(bad[None])
    with pytest.raises(ValueError, match="exactly 2 data rows"):
        _code(2, 1, "gather").encode(bad)


def test_stream_reuses_its_staging_and_fills_stages():
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, size=(5, 2, 300), dtype=np.uint8)
    stages = {}
    stream = rs.RSStream(_code(2, 1, "gather"), slab=2, stages=stages)
    first = stream.run_batch(data)
    bufs = [b.data_ptr() for d in ("in", "out") for b in stream._staging[d]]
    again = stream.run_batch(data)
    assert [b.data_ptr() for d in ("in", "out") for b in stream._staging[d]] == bufs
    np.testing.assert_array_equal(first, again)
    assert set(stages) == set(rs.RS_STAGE_NAMES)


# ------------------------------------------------------- grouped recovery


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("k,m,n", [(2, 1, 501), (12, 4, 129)])
def test_host_grouped_matches_per_item_reference(path, k, m, n):
    data, pats, surv = _mixed_batch(k, m, 11, n, seed=k * 100 + n)
    got = _code(k, m, path).reconstruct_batch(surv, pats)
    assert isinstance(got, np.ndarray)
    for i in range(len(pats)):
        np.testing.assert_array_equal(got[i], gf256.rs_decode_ref(surv[i], pats[i], k, m))
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, jrs.RSCode(k, m, path=path).reconstruct_batch(surv, pats))


@pytest.mark.parametrize("path", PATHS)
def test_grouped_slabs_scatter_in_segment_order(path):
    """Three masks over nine segments, slabs of 4 (full and partial
    slabs in every group): rows land back in segment order."""
    rng = np.random.default_rng(19)
    data = rng.integers(0, 256, size=(9, 5, 640), dtype=np.uint8)
    allsh = np.stack([np.concatenate([d, gf256.rs_encode_ref(d, 5, 3)]) for d in data])
    pats = [sorted({0, 1, 2, 3, 4, 5, 6, 7} - {i % 3, 5 + i % 3})[:5] for i in range(9)]
    surv = np.stack([allsh[i, pats[i]] for i in range(9)])
    got = rs.RSStream(_code(5, 3, path), present=pats, slab=4).run_batch(surv)
    np.testing.assert_array_equal(got, data)
    want = jrs.RSStream(jrs.RSCode(5, 3, path=path), present=pats, slab=4).run_batch(surv)
    np.testing.assert_array_equal(got, want)


def test_grouped_encode_stream():
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, size=(9, 2, 700), dtype=np.uint8)
    got = rs.RSStream(_code(2, 1, "gather"), slab=4).run_batch(data)
    want = np.stack([gf256.rs_encode_ref(d, 2, 1) for d in data])
    np.testing.assert_array_equal(got, want)


def test_pattern_count_mismatch():
    surv = np.zeros((3, 2, 32), dtype=np.uint8)
    with pytest.raises(ValueError, match="survivor lists for"):
        _code(2, 1, "gather").reconstruct_batch(surv, [[0, 1], [1, 2]])


# ------------------------------------------------------------- validation


@pytest.mark.parametrize("present,msg", [
    ([1, 1], "duplicate"),
    ([0, 5], "out of range"),
    ([-1, 2], "out of range"),
    ([0], "need 2 shards"),
])
def test_bad_present_fails_loudly(present, msg):
    code = _code(2, 1, "gather")
    shards = np.zeros((2, 64), dtype=np.uint8)
    with pytest.raises(ValueError, match=msg):
        code.reconstruct(shards, present)
    with pytest.raises(ValueError, match=msg):
        code.recovery_matrix(present)
    with pytest.raises(ValueError, match=msg):
        rs.RSStream(code, present=present)
    with pytest.raises(ValueError, match=msg):
        jrs.RSCode(2, 1, path="gather").recovery_matrix(present)


def test_bad_shard_arrays():
    code = _code(2, 1, "gather")
    with pytest.raises(ValueError, match="2-D"):
        code.encode(np.zeros(64, dtype=np.uint8))
    with pytest.raises(ValueError, match="empty"):
        code.encode(np.zeros((2, 0), dtype=np.uint8))
    with pytest.raises(ValueError, match="3-D"):
        code.encode_batch(np.zeros((2, 64), dtype=np.uint8))
    with pytest.raises(ValueError, match="need 2 shard rows"):
        code.reconstruct(np.zeros((1, 64), dtype=np.uint8), [0, 1])
    with pytest.raises(ValueError, match="3-D"):
        rs.RSStream(code).run_batch(np.zeros((2, 64), dtype=np.uint8))


@pytest.mark.parametrize("kw,msg", [
    ({"k": 2, "m": 1, "path": "mxu"}, "unknown RS path"),
    ({"k": 0, "m": 1}, "k >= 1"),
    ({"k": 200, "m": 57}, "<= 256"),
])
def test_bad_code_parameters(kw, msg):
    with pytest.raises(ValueError, match=msg):
        rs.RSCode(device="cpu", **kw)


# --------------------------------------------------- constants and paths


def test_recovery_matrix_matches_jax_and_is_a_copy():
    code = _code(12, 4, "gather")
    present = [0, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15]
    inv = code.recovery_matrix(present)
    np.testing.assert_array_equal(inv, jrs.RSCode(12, 4, path="gather").recovery_matrix(present))
    inv[:] = 0
    assert code.recovery_matrix(present).any()


def test_device_constants_shared_across_codes():
    for path in PATHS:
        a, b = _code(12, 4, path), _code(12, 4, path)
        assert a._parity_op is b._parity_op
    assert _code(12, 4, "gather")._parity_op.shape == (4, 12, 256)
    assert _code(12, 4, "bitplane")._parity_op.dtype == torch.float16


def test_default_path_and_segment_code():
    assert rs.default_path("cpu") == "gather"
    assert rs.default_path("cuda") in PATHS
    code = rs.segment_code(device="cpu")
    assert (code.k, code.m, code.path) == (rs.SEGMENT_K, rs.SEGMENT_M, "gather")
    assert (rs.SEGMENT_K, rs.SEGMENT_M) == (jrs.SEGMENT_K, jrs.SEGMENT_M)
    assert (rs.TILE, rs.SLAB) == (jrs.TILE, jrs.SLAB)
