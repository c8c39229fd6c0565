# Entry points of the port: launch/serve.py serves a model with
# ServingEngine.  The reference's mesh, train and dry-run launchers wait
# for ROADMAP §1 item 5(e) and 5(g).
