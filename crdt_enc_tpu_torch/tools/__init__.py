"""Operational tools around the port's core: the fleet daemon's entry
point (:mod:`.daemon`)."""
