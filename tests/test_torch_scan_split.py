"""The host side of kernels B7 (RG-LRU scan) and B4 (LSTM cell): the tiling
each wrapper picks and passes to its kernel (``rglru_scan.scan_tiles``,
``lstm_cell.cell_tiles``).

B7: the CTAs' channel blocks tile every (b, r) exactly once, the ring's
copies put every step of a and b in the stage the chain reads, the grid
reaches all 132 SMs of an H100 at recurrentgemma-2b's width, the ring fits
shared memory (64 KB, three CTAs an SM) at every shape the serve paths give
it, and a decode step (S = 1) takes the direct form.  B4: the grid reaches every SM at Table 1's
LSTM shape and its grid-stride loop covers every column once for odd N and
H.  The index arithmetic below mirrors the kernels' (``csrc/*.cu``)."""
import itertools

import pytest

from repro_torch.kernels.lstm_cell import ops as cell_ops
from repro_torch.kernels.lstm_cell import cell_tiles
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan import scan_tiles

H100_SMS = 132
RG_WIDTH = 2560             # recurrentgemma-2b's RG-LRU width
SMOKE_WIDTH = 64            # the smoke config's


def _channel_blocks(B, R, channels):
    """(b, r0, nc) of every CTA, as rglru_scan_staged derives them from
    blockIdx."""
    for bb, bx in itertools.product(range(B), range(-(-R // channels))):
        r0 = bx * channels
        yield bb, r0, min(channels, R - r0)


def _ring_copies(S, nc, tiles, vec16):
    """(t, c, stage row) of every float the copy warps put in the ring (each
    index copies a and b alike), as the copy loop computes them."""
    kw = 4 if vec16 else 1
    per_row = nc // kw
    seen = []
    for k in range(-(-S // tiles.chunk)):
        t0 = k * tiles.chunk
        n = min(S - t0, tiles.chunk)
        for i in range(n * per_row):
            t, c = divmod(i, per_row)
            seen += [(t0 + t, c * kw + e, t) for e in range(kw)]
    return seen


SHAPES = [(1, 333, 2560), (4, 333, 2560), (1, 2048, 2560), (2, 37, 200), (3, 101, 1030),
          (2, 77, 2052), (3, 5, 1), (8, 2, 64), (1, 9, 7)]


@pytest.mark.parametrize("B,S,R", SHAPES)
def test_channel_blocks_tile_every_channel_once(B, S, R):
    tiles = scan_tiles(B, S, R, H100_SMS)
    assert tiles.channels in (4, 8, 16, 32)          # the kernel's instantiations
    owners = [(bb, r0 + c) for bb, r0, nc in _channel_blocks(B, R, tiles.channels)
              for c in range(nc)]
    assert sorted(owners) == [(bb, r) for bb in range(B) for r in range(R)]


@pytest.mark.parametrize("B,S,R", SHAPES)
def test_ring_copies_every_step_into_the_row_the_chain_reads(B, S, R):
    tiles = scan_tiles(B, S, R, H100_SMS)
    assert tiles.chunk % 8 == 0 and 1 <= tiles.stages <= 4
    # the kernel takes 16-byte copies only where R and the block are multiples of 4
    for vec16 in ([False, True] if R % 4 == 0 and tiles.channels % 4 == 0 else [False]):
        blocks = list(_channel_blocks(1, R, tiles.channels))
        for _, _, nc in {blocks[0], blocks[-1]}:       # a full block and the last one
            got = _ring_copies(S, nc, tiles, vec16)
            assert sorted((t, c) for t, c, _ in got) == [(t, c) for t in range(S)
                                                         for c in range(nc)]
            # step t sits in row t mod chunk of its stage
            assert all(row == t % tiles.chunk for t, _, row in got)


@pytest.mark.parametrize("B,S", [(1, 333), (1, 2048), (1, 200), (4, 333), (4, 200), (8, 2)])
def test_grid_reaches_every_sm_at_recurrentgemma_width(B, S):
    tiles = scan_tiles(B, S, RG_WIDTH, H100_SMS)
    assert B * -(-RG_WIDTH // tiles.channels) >= H100_SMS
    if B == 1:
        assert tiles.channels == 16          # 160 CTAs, where one warp a CTA gave 80


@pytest.mark.parametrize("R", [RG_WIDTH, SMOKE_WIDTH])
def test_ring_fits_shared_memory_at_every_serving_shape(R):
    """Slot prefills (B = 1, any prompt up to the 2048-token window), wave
    prefills (B up to 8) and chunked decode-length inputs."""
    for B, S in itertools.product((1, 2, 4, 8), (2, 3, 8, 37, 64, 65, 200, 333, 1024, 2048)):
        tiles = scan_tiles(B, S, R, H100_SMS)
        assert scan_ops.ring_bytes(*tiles) <= 64 * 1024 + 16 * tiles.stages, (B, S, R, tiles)
        assert scan_ops.ring_bytes(*tiles) <= scan_ops.MAX_SMEM


@pytest.mark.parametrize("B,R", [(1, RG_WIDTH), (8, RG_WIDTH), (3, 200), (8, SMOKE_WIDTH)])
def test_decode_step_takes_the_direct_form(B, R):
    assert scan_tiles(B, 1, R, H100_SMS) == (0, 0, 0)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("N,H", [(64, 1024), (256, 1024)])
def test_cell_grid_reaches_every_sm_at_the_lstm_shape(N, H, itemsize):
    """Table 1's "large" LSTM: batch 64 per cell (the sequential and
    runtime paths) and L x B = 256 rows (the stacked wavefront), f32 and
    bf16 gates: one 4-byte word a thread."""
    tiles = cell_tiles(N, H, itemsize, H100_SMS)
    assert cell_ops.ctas(N, H, tiles) >= H100_SMS
    assert tiles.cols * itemsize == 4
    if (N, itemsize) == (64, 4):
        assert tiles == (1, 256)             # 256 CTAs, where 4 x 256 gave 64


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("N,H", [(37, 200), (1, 3), (67, 1000), (65, 1023), (3, 7), (1, 1)])
def test_cell_grid_covers_every_column_once(N, H, itemsize):
    """The grid-stride loop of lstm_cell_kernel: thread v takes columns
    [j0, j0 + cols) of row n, clipped to H, for v < N * ceil(H / cols)."""
    tiles = cell_tiles(N, H, itemsize, H100_SMS)
    n_threads = cell_ops.ctas(N, H, tiles) * tiles.threads
    per_row = -(-H // tiles.cols)
    cover = []
    for first in range(n_threads):
        for v in range(first, N * per_row, n_threads):
            n, j0 = divmod(v, per_row)
            cover += [(n, j) for j in range(j0 * tiles.cols, min(j0 * tiles.cols + tiles.cols,
                                                                   H))]
    assert sorted(cover) == [(n, j) for n in range(N) for j in range(H)]
