# Entry points of the port: launch/serve.py serves a model with
# ServingEngine, launch/train.py trains one through train.loop, and
# launch/mesh.py builds the production and host meshes.  The reference's
# dry-run launcher waits for ROADMAP §1 item 5(g)(iii).
