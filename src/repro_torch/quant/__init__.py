"""ICQ x LM integration (twin of ``repro.quant``): the paper's two-step
machinery inside LM serving.

  int8.py          int8 quantize / dequantize with per-slice scales
  kv_cache.py      ICQ-KV: interleaved-subspace quantized KV cache with
                   crude-first two-step attention at decode
  serve_icq.py     the ICQ-KV decode step of the dense decoder LMs
  grad_compress.py cross-pod gradient compression with error feedback
"""
from repro_torch.quant.int8 import quantize_int8, dequantize_int8
from repro_torch.quant.kv_cache import (ICQKVConfig, build_icq_kv_cache,
                                        icq_kv_append,
                                        icq_kv_decode_attention,
                                        init_icq_kv_cache)
from repro_torch.quant.grad_compress import (compress_state_init,
                                             compressed_cross_pod_mean,
                                             ef_quantize)

__all__ = [
    "quantize_int8", "dequantize_int8",
    "ICQKVConfig", "build_icq_kv_cache", "icq_kv_append",
    "icq_kv_decode_attention", "init_icq_kv_cache",
    "compress_state_init", "compressed_cross_pod_mean", "ef_quantize",
]
