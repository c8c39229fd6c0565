"""Training: AdamW (``optimizer.py``), the train step with microbatch
accumulation (``train_step.py``) and the fault-tolerant loop
(``loop.py``), the port of ``repro/train``."""
