from .ops import CellTiles, cell_tiles, lstm_cell_cuda, lstm_cell_fused, lstm_cell_plain

__all__ = ["CellTiles", "cell_tiles", "lstm_cell_cuda", "lstm_cell_fused", "lstm_cell_plain"]
