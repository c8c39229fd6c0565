"""Evaluation switches of the model stack that mean something on one card.

The reference's ``unroll_scans``, ``moe_impl``, ``remat_policy`` and
``serving_layout`` steer XLA lowering, the mesh or training; they come
with those parts of the port.
"""

# decode attention: 'repeat' materializes GQA-repeated K/V; 'grouped'
# contracts grouped q-heads against the raw cache.
decode_gqa: str = "repeat"
# cross-entropy: 'onehot' takes the log-sum-exp of f32 logits; 'fused'
# reduces the logits in their own dtype with f32 accumulation.
xent_impl: str = "onehot"
# flash attention KV block length; attention goes blockwise past it
kv_block: int = 1024
