from .ops import ssm_scan, ssm_scan_bwd_cuda, ssm_scan_bwd_plain, ssm_scan_cuda, ssm_scan_plain

__all__ = ["ssm_scan", "ssm_scan_bwd_cuda", "ssm_scan_bwd_plain", "ssm_scan_cuda",
           "ssm_scan_plain"]
