# Continuous-batching scan server over the port's LSMTree.
from repro_torch.serving.scan_server import (AggRequest, ScanRequest,
                                             ScanServer, ScanServerStats)

__all__ = ["AggRequest", "ScanRequest", "ScanServer", "ScanServerStats"]
