from .ops import rglru_scan, rglru_scan_cuda, rglru_scan_plain

__all__ = ["rglru_scan", "rglru_scan_cuda", "rglru_scan_plain"]
