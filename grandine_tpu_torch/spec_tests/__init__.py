"""The port's copy of the spec-test helpers it needs (the snappy framing
of its storage)."""
