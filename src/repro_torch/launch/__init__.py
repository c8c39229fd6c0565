# Entry points of the port: launch/serve.py serves a model with
# ServingEngine, launch/train.py trains one through train.loop,
# launch/mesh.py builds the production and host meshes, and
# launch/dryrun.py traces every (architecture x shape x mesh) cell on a
# fake process group for its roofline on the card's rates (launch/card.py).
