from repro_torch.storage.devices import DEVICES, DeviceModel, get_device
from repro_torch.storage.io import FileStore, IOStats

__all__ = ["DEVICES", "DeviceModel", "get_device", "FileStore", "IOStats"]
