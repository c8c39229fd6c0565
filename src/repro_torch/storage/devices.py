"""Storage-device models for the paper's three device classes.

Port of ``repro/storage/devices.py`` (host data only).  The engine keeps
its SCTs in memory and counts the bytes and I/O requests every read and
write would cost on disk; a ``DeviceModel`` turns those counts into
modeled I/O seconds with the sequential bandwidths and access latencies
the paper reports for its testbed (HDD 180 MB/s, SATA SSD 400 MB/s, NVMe
SSD ~2.3 GB/s).  ``LSMTree.io_report`` applies one.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    read_bw: float      # bytes / second, sequential
    write_bw: float     # bytes / second, sequential
    io_latency: float   # seconds per I/O request (seek + queue)

    def read_seconds(self, nbytes: int, n_ios: int = 1) -> float:
        return nbytes / self.read_bw + n_ios * self.io_latency

    def write_seconds(self, nbytes: int, n_ios: int = 1) -> float:
        return nbytes / self.write_bw + n_ios * self.io_latency


# Paper §5.1: "12TB HDD, 1TB SATA SSD, 4TB NVMe SSD, which can achieve up
# to about 180 MBs, 400MBps and 2300MBs sequential I/O performance".
HDD = DeviceModel("hdd", read_bw=180e6, write_bw=160e6, io_latency=8e-3)
SATA_SSD = DeviceModel("sata_ssd", read_bw=400e6, write_bw=360e6, io_latency=1e-4)
NVME_SSD = DeviceModel("nvme_ssd", read_bw=2300e6, write_bw=2000e6, io_latency=2e-5)

DEVICES = {d.name: d for d in (HDD, SATA_SSD, NVME_SSD)}


def get_device(name: str) -> DeviceModel:
    try:
        return DEVICES[name]
    except KeyError:
        raise KeyError(f"unknown device {name!r}; options: {sorted(DEVICES)}")
