"""The port's content hashing against the JAX package's, on the CPU: the
plain twin of the card's weighted-sum kernel (``layer1_sums_ref``)
against ``content_hash``'s numpy layer 1, the digest assembled from
uploaded bytes (``uploaded_fingerprint``, the card path's host half)
against ``content_fingerprint``, the identity cache's hit flag, and the
fingerprint counters of ``engine.transfer_arrays``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimesh_tpu import hashing as jhash  # noqa: E402
from multimesh_tpu_torch import engine as tengine  # noqa: E402
from multimesh_tpu_torch import hashing as thash  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch import utils_profile as tprofile  # noqa: E402

C = thash.HASH_COLS


@pytest.fixture(autouse=True)
def _own_identity_cache(monkeypatch):
    """Each test's frozen arrays stay out of the process's identity cache,
    whose stale entries other tests' fresh arrays could share an id with."""
    monkeypatch.setattr(thash, "_FROZEN_CACHE", {})


def _words(n32, extra_bytes=0, seed=0):
    """Random bytes: ``n32`` whole words and ``extra_bytes`` more."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, 4 * n32 + extra_bytes, dtype=np.uint8)


def _f64(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape) * 6.3e6


HASH_CASES = {
    "empty": lambda: np.zeros(0, np.float64),
    "one_byte": lambda: np.array([7], np.uint8),
    "three_bytes": lambda: np.array([1, 2, 3], np.uint8),
    "one_word": lambda: np.ones(1, np.float32),
    "under_a_row": lambda: _words(C - 1, 3),
    "one_row": lambda: _words(C),
    "three_rows": lambda: _words(3 * C),
    "leftover_1": lambda: _words(2 * C + 1),
    "leftover_4095_and_tail": lambda: _words(2 * C + C - 1, 2),
    "r255": lambda: _words(255 * C + 9),
    "r256": lambda: _words(256 * C),
    "r300_leftover_rows": lambda: _words(300 * C + 77, 1),
    "r513_f32": lambda: _f64(513 * C + 5).astype(np.float32),
    "f64_elements": lambda: _f64((300, 125, 3)),
    "f64_noncontiguous": lambda: _f64((60, 125, 6))[:, :, ::2],
    "f64_big_endian": lambda: _f64((300, 125, 3)).astype(">f8"),
}


def _head(a):
    """(R, the [R, C] uint32 head of ``a``'s bytes, or None under a row)."""
    b8 = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    R = b8.size // 4 // C
    return R, (b8[: 4 * R * C].view(np.uint32).reshape(R, C) if R else None)


@pytest.mark.parametrize("case", list(HASH_CASES))
def test_twin_and_uploaded_digest_equal_content_hash(case):
    """Layer 1 by the twin (int64 masked to 32 bits) equals the numpy
    layer 1 of ``content_hash``, all four sums bit for bit; the digest
    from uploaded bytes, ``content_fingerprint_device`` on the CPU and
    the port's ``content_fingerprint`` all equal the JAX package's."""
    a = HASH_CASES[case]()
    want = jhash.content_fingerprint(a)
    R, head = _head(a)
    if head is not None:
        words = torch.from_numpy(head.view(np.int32).copy())
        col, row, colw, roww = thash.layer1_sums_host(head)
        for got in (thash.layer1_sums_ref(words), thash.layer1_sums(words)):
            assert got.dtype == torch.int32 and got.shape == (2 * C + 2 * R,)
            got = got.numpy().view(np.uint32)
            np.testing.assert_array_equal(got[:C], col)
            np.testing.assert_array_equal(got[C:2 * C], colw)
            np.testing.assert_array_equal(got[2 * C:2 * C + R], row)
            np.testing.assert_array_equal(got[2 * C + R:], roww)
    host = np.ascontiguousarray(a)
    b8 = host.reshape(-1).view(np.uint8)
    pages = thash._pages_digest(b8)
    assert thash.uploaded_fingerprint(host, torch.from_numpy(b8),
                                      pages) == want
    assert thash.content_fingerprint_device(a, "cpu") == (want, None)
    assert thash.content_fingerprint(a) == want
    assert thash.content_hash(a) == jhash.content_hash(a)


@pytest.mark.parametrize("words", [
    torch.zeros((2, C), dtype=torch.int64),
    torch.zeros((2, C - 1), dtype=torch.int32),
    torch.zeros((0, C), dtype=torch.int32),
    torch.zeros((C, 2), dtype=torch.int32).T,
    torch.zeros(C, dtype=torch.int32),
])
def test_layer1_sums_refuses_what_the_kernel_does_not_take(words):
    with pytest.raises(ValueError, match="layer1_sums"):
        thash.layer1_sums(words)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_array_fingerprint_hit_says_when_the_cache_answered(device):
    """A frozen array: a miss, then hits with the same fingerprint; a
    writable one is hashed on every call; a refrozen edit misses."""
    a = _f64((40, 125, 3))
    want = jhash.content_fingerprint(a)
    assert thash.array_fingerprint_hit(a, device) == (want, False)
    assert thash.array_fingerprint_hit(a, device) == (want, False)
    a.setflags(write=False)
    assert thash.array_fingerprint_hit(a, device) == (want, False)
    assert thash.array_fingerprint_hit(a, device) == (want, True)
    assert thash.array_fingerprint(a) == want
    a.setflags(write=True)
    a[3, 7, 1] += 1.0
    a.setflags(write=False)
    fp, hit = thash.array_fingerprint_hit(a, device)
    assert not hit and fp == jhash.content_fingerprint(a) != want


def test_transfer_arrays_counts_its_fingerprints(monkeypatch):
    """``engine.transfer_arrays`` on the CPU: the target's and a writable
    source's weighted-sum layers run on the host (their head bytes in
    ``fingerprint.host_bytes``, none on the card); a frozen source is
    hashed by the first call only, and each later call counts one
    ``fingerprint.frozen_hits``."""
    src = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=4)
    tgt = tmt.shell_mesh(n_lat=2, n_lon=2, n_rad=2, order=4,
                         r_inner=3.6e6, r_outer=6.3e6,
                         lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
    base = tmt.element_nodal_field(src)
    src_data = np.stack([base, 1.1 * base], axis=1)
    E, n = tgt.points.shape[:2]
    old = np.ones((E, 2, n))
    head = {name: _head(a)[0] * C * 4
            for name, a in (("src", src.points), ("tgt", tgt.points))}
    monkeypatch.setenv("MMT_PROFILE", "1")

    def run(src_points):
        tprofile.reset_stages()
        tengine.transfer_arrays(
            src_points, src_data, ["VP", "VS"], tgt.points, old,
            np.ones(E, bool), lambda names: np.zeros(old.shape),
            device="cpu")
        counters = {k: v for k, v in tprofile.counter_totals().items()
                    if k.startswith("fingerprint.")}
        tprofile.reset_stages()
        return counters

    # a writable source is hashed once a call: locate's mesh prep takes
    # its fingerprint from the identity cache
    for _ in range(2):
        counters = run(src.points.copy())
        assert counters == {"fingerprint.host_bytes": head["src"] + head["tgt"],
                            "fingerprint.frozen_hits": 0}
    frozen = src.points.copy()
    frozen.setflags(write=False)
    first = run(frozen)
    assert first["fingerprint.frozen_hits"] == 0
    assert first["fingerprint.host_bytes"] >= head["src"] + head["tgt"]
    for _ in range(2):
        assert run(frozen) == {"fingerprint.host_bytes": head["tgt"],
                               "fingerprint.frozen_hits": 1}
