from .ops import (CellTiles, cell_tiles, lstm_cell_bwd_cuda, lstm_cell_bwd_plain, lstm_cell_cuda,
                  lstm_cell_fused, lstm_cell_plain)

__all__ = ["CellTiles", "cell_tiles", "lstm_cell_bwd_cuda", "lstm_cell_bwd_plain",
           "lstm_cell_cuda", "lstm_cell_fused", "lstm_cell_plain"]
