# Entry points of the port: launch/serve.py serves a model with
# ServingEngine, launch/train.py trains one through train.loop.  The
# reference's mesh and dry-run launchers wait for ROADMAP §1 item 5(g).
