from .ops import (BWD_TILE, moe_gmm, moe_gmm_bwd_cuda, moe_gmm_bwd_dw_first, moe_gmm_bwd_path,
                  moe_gmm_bwd_plain, moe_gmm_bwd_tiles, moe_gmm_cuda, moe_gmm_path, moe_gmm_plain)

__all__ = ["BWD_TILE", "moe_gmm", "moe_gmm_bwd_cuda", "moe_gmm_bwd_dw_first", "moe_gmm_bwd_path",
           "moe_gmm_bwd_plain", "moe_gmm_bwd_tiles", "moe_gmm_cuda", "moe_gmm_path",
           "moe_gmm_plain"]
