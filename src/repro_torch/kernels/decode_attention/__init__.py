from .ops import (decode_attention, decode_attention_cuda, decode_attention_plain, decode_split,
                  paged_decode_attention, paged_decode_attention_cuda,
                  paged_decode_attention_plain)

__all__ = ["decode_attention", "decode_attention_cuda", "decode_attention_plain",
           "decode_split", "paged_decode_attention", "paged_decode_attention_cuda",
           "paged_decode_attention_plain"]
