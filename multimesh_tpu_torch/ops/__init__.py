"""Transfer operators."""
from .transfer import TransferOperator  # noqa: F401
