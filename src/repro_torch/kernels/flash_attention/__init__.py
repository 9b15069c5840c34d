from .ops import (flash_attention, flash_attention_bwd_cuda, flash_attention_bwd_path,
                  flash_attention_bwd_plain, flash_attention_cuda, flash_attention_path,
                  flash_attention_plain, flash_attention_train, flash_attention_train_cuda,
                  flash_bwd_splits, flash_padded_hd)

__all__ = ["flash_attention", "flash_attention_bwd_cuda", "flash_attention_bwd_path",
           "flash_attention_bwd_plain", "flash_attention_cuda", "flash_attention_path",
           "flash_attention_plain", "flash_attention_train", "flash_attention_train_cuda",
           "flash_bwd_splits", "flash_padded_hd"]
