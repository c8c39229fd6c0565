# Analytics tier of the port: only the SUM weight definition so far.
from repro_torch.query.spec import numeric_values

__all__ = ["numeric_values"]
