"""Training loops: one per kind of traffic file (its "loop" key)."""
