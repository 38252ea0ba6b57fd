"""Operational tools around the port's core: the fleet daemon's entry
point (:mod:`.daemon`: ``run`` and ``selftest``), the remote integrity
checker (:mod:`.fsck`) and the simulator's entry point (:mod:`.sim`)."""
