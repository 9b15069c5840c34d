from .ops import (CKPT_CHUNK, ssm_scan, ssm_scan_bwd_cuda, ssm_scan_bwd_plain, ssm_scan_cuda,
                  ssm_scan_plain, ssm_scan_train, ssm_scan_train_cuda, ssm_scan_train_plain)

__all__ = ["CKPT_CHUNK", "ssm_scan", "ssm_scan_bwd_cuda", "ssm_scan_bwd_plain", "ssm_scan_cuda",
           "ssm_scan_plain", "ssm_scan_train", "ssm_scan_train_cuda", "ssm_scan_train_plain"]
