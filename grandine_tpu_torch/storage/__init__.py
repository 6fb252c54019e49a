"""The port's storage: the key-value `Database` (in memory or sqlite3).
`Storage`, the chain store over it, needs the SSZ types and waits for
them."""

from grandine_tpu_torch.storage.database import Database

__all__ = ["Database"]
