"""Flash attention: softmax attention online over KV tiles, fp32 inside."""
