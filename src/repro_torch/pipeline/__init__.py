# The LSM-OPD-backed training-data store.
from repro_torch.pipeline.tokenstore import TokenStore, TokenStoreConfig

__all__ = ["TokenStore", "TokenStoreConfig"]
