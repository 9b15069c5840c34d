from .ops import lstm_cell_cuda, lstm_cell_fused, lstm_cell_plain

__all__ = ["lstm_cell_cuda", "lstm_cell_fused", "lstm_cell_plain"]
