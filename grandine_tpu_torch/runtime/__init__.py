"""Runtime types the verify path takes in (VerifyItem)."""
