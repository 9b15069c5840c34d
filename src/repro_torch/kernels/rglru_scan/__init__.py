from .ops import (ScanTiles, rglru_scan, rglru_scan_bwd_cuda, rglru_scan_bwd_plain,
                  rglru_scan_cuda, rglru_scan_plain, scan_tiles)

__all__ = ["ScanTiles", "rglru_scan", "rglru_scan_bwd_cuda", "rglru_scan_bwd_plain",
           "rglru_scan_cuda", "rglru_scan_plain", "scan_tiles"]
