"""Evaluation switches of the model stack that mean something on one card.

The reference's ``unroll_scans``, ``moe_impl`` and ``remat_policy``
steer XLA lowering, the mesh or training; they come with those parts of
the port.  ``serving_layout`` is here for the specs alone.
"""

# decode attention: 'repeat' materializes GQA-repeated K/V; 'grouped'
# contracts grouped q-heads against the raw cache.
decode_gqa: str = "repeat"
# cross-entropy: 'onehot' takes the log-sum-exp of f32 logits; 'fused'
# reduces the logits in their own dtype with f32 accumulation.
xent_impl: str = "onehot"
# flash attention KV block length; attention goes blockwise past it
kv_block: int = 1024
# serving parameter/cache layout: 'batch' = the train layout (batch over
# the data axes); 'tp2d' = weights and the KV cache's sequence sharded
# over both mesh axes, batch replicated.  Here it only chooses the specs
# (registry.batch_pspec); the forward's 'tp2d' comes with the mesh in the
# forward (ROADMAP §1 item 5(g)(ii)).
serving_layout: str = "batch"
