"""Evaluation switches of the model stack.

The reference's ``unroll_scans`` has no counterpart: it unrolls the
``lax.scan`` over layers for XLA's cost analysis, and the port's layers
are a Python loop that every counter sees at full depth (ROADMAP §3).
"""

# decode attention: 'repeat' materializes GQA-repeated K/V; 'grouped'
# contracts grouped q-heads against the raw cache.
decode_gqa: str = "repeat"
# MoE dispatch on a mesh: 'gather' = ``moe_ffn`` of the global batch (the
# tokens gathered over the data axes, capacity and aux from all of them);
# 'ep' = expert parallel, each data shard routed on its own (capacity per
# shard and expert, the aux a mean over the shards).  Any other value
# raises ValueError in a moe layer.
moe_impl: str = "gather"
# cross-entropy: 'onehot' takes the log-sum-exp of f32 logits; 'fused'
# reduces the logits in their own dtype with f32 accumulation.
xent_impl: str = "onehot"
# flash attention KV block length; attention goes blockwise past it
kv_block: int = 1024
# remat policy for a layer under cfg.remat: 'nothing' recomputes every
# activation in the backward; 'dots' keeps the outputs of products with
# no batch dimension (transformer.remat)
remat_policy: str = "nothing"
# serving parameter/cache layout: 'batch' = the train layout (batch over
# the data axes); 'tp2d' = weights and the KV cache's sequence sharded
# over both mesh axes, batch replicated.  It chooses the specs
# (registry.batch_pspec) and, on a mesh, how transformer.decode_step
# places its batch ('tp2d': force_dp_none).
serving_layout: str = "batch"
