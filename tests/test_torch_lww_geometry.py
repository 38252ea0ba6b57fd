"""The launch geometry of the LWW fold kernel (ops/lww_fold_cuda.py), on
the CPU.

The kernel itself runs only on the card (tests/test_torch_kernels.py);
its route (shared-memory tile or global table) and its grid — resident
blocks, rows a thread keeps in registers, chunks past register residency
— are plain Python, checked here at the edges: N = 0, K = 0, one key, the
shared-memory threshold, and batches past residency.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC

H100_SMS = 132


def test_constants_match_the_kernel_source():
    src = (Path(LC.__file__).parent.parent / "csrc" / "lww_fold.cu").read_text()
    assert int(re.search(r"kThreads = (\d+);", src)[1]) == LC.THREADS
    assert int(re.search(r"kRowsMax = (\d+);", src)[1]) == LC.ROWS_MAX
    # both slots of every tile key fit a Hopper block's shared memory
    assert 16 * LC.TILE_KEYS_MAX <= 232_448


@pytest.mark.parametrize("K,tile", [
    (1, 4), (3, 4), (4, 4), (5, 8), (1000, 1000), (1001, 1004),
    (LC.SHARED_KEYS_MAX, LC.SHARED_KEYS_MAX), (LC.SHARED_KEYS_MAX + 1, 0),
    (1_000_000, 0),
])
def test_route_by_the_threshold(K, tile):
    assert LC.lww_tile(K) == tile


@pytest.mark.parametrize("K", [1, 999, 12_288, 12_289, 15_000, 1_000_000])
def test_forced_routes(K, monkeypatch):
    monkeypatch.setattr(LC, "SHARED_KEYS_MAX", 2**31 - 1)
    assert LC.lww_tile(K) == min(-(-K // 4) * 4, LC.TILE_KEYS_MAX)
    monkeypatch.setattr(LC, "SHARED_KEYS_MAX", 0)
    assert LC.lww_tile(K) == 0


# (N, K, blocks per SM) -> (blocks, rows per thread, chunks) on 132 SMs;
# the kernel holds one block per SM on an H100 (128 registers a thread)
GEOMETRIES = {
    "config 4": ((1_000_000, 1_000_000, 1), (123, 16, 1)),
    "config 4, two blocks per SM": ((1_000_000, 1_000_000, 2), (123, 16, 1)),
    "past residency, 2^23 rows": ((1 << 23, 1_000_000, 1), (132, 16, 8)),
    "heavy ties": ((1_000_000, 1000, 1), (123, 16, 1)),
    "no rows": ((0, 1_000_000, 1), (123, 1, 0)),
    "no rows, one key": ((0, 1, 1), (1, 1, 0)),
    "no keys": ((5000, 0, 1), (1, 10, 1)),
    "tiny": ((7, 5, 1), (1, 1, 1)),
    "one block of rows": ((8192, 10, 1), (1, 16, 1)),
    "one row past one block": ((8193, 10, 1), (2, 9, 1)),
}


@pytest.mark.parametrize("case", sorted(GEOMETRIES))
def test_geometry(case):
    (N, K, per_sm), (blocks, rows, chunks) = GEOMETRIES[case]
    geo = LC.lww_geometry(N, K, LC.lww_tile(K), H100_SMS, per_sm)
    assert (geo.blocks, geo.rows_per_thread, geo.chunks) == (blocks, rows,
                                                             chunks)
    assert geo.smem_bytes == 16 * geo.tile_keys


@pytest.mark.parametrize("N", [0, 1, 511, 512, 8191, 8192, 8193, 100_000,
                               1_081_343, 1_081_344, 1_081_345, 3_000_000,
                               (1 << 23) + 3])
@pytest.mark.parametrize("K", [0, 1, 3, 12_288, 1_000_000])
@pytest.mark.parametrize("sms,per_sm", [(1, 1), (132, 1), (132, 2), (132, 4)])
def test_geometry_covers_every_row_and_key(N, K, sms, per_sm):
    geo = LC.lww_geometry(N, K, LC.lww_tile(K), sms, per_sm)
    per_chunk = geo.blocks * LC.THREADS * geo.rows_per_thread
    assert 1 <= geo.blocks <= sms * per_sm  # every block resident
    assert 1 <= geo.rows_per_thread <= LC.ROWS_MAX
    assert geo.chunks * per_chunk >= N > (geo.chunks - 1) * per_chunk
    if geo.chunks > 1:  # past residency: the registers are full
        assert geo.rows_per_thread == LC.ROWS_MAX
        assert geo.blocks == sms * per_sm
    assert geo.keys_padded % 4 == 0 and 0 <= geo.keys_padded - K < 4
    assert geo.tile_keys <= max(geo.keys_padded, 0)


def test_geometry_refuses_a_card_that_holds_no_block():
    with pytest.raises(RuntimeError, match="holds no block"):
        LC.lww_geometry(10, 10, 12, H100_SMS, 0)
