from repro_torch.storage.io import FileStore, IOStats

__all__ = ["FileStore", "IOStats"]
