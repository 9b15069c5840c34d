from .ops import (moe_gmm, moe_gmm_bwd_cuda, moe_gmm_bwd_path, moe_gmm_bwd_plain, moe_gmm_cuda,
                  moe_gmm_path, moe_gmm_plain)

__all__ = ["moe_gmm", "moe_gmm_bwd_cuda", "moe_gmm_bwd_path", "moe_gmm_bwd_plain",
           "moe_gmm_cuda", "moe_gmm_path", "moe_gmm_plain"]
