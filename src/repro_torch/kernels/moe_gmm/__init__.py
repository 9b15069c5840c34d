from .ops import moe_gmm, moe_gmm_cuda, moe_gmm_path, moe_gmm_plain

__all__ = ["moe_gmm", "moe_gmm_cuda", "moe_gmm_path", "moe_gmm_plain"]
