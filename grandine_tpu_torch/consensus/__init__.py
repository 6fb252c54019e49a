"""Consensus-layer types the verify path raises (SignatureInvalid)."""
