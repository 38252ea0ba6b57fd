"""Operational tools around the port's core: the fleet daemon's entry
point (:mod:`.daemon`: ``run`` and ``selftest``), the remote integrity
checker (:mod:`.fsck`), the simulator's entry point (:mod:`.sim`), the
operator's read side over sink files (:mod:`.obs_report`), and the
migration tools to and from a remote of the reference implementation
(:mod:`.import_reference`, :mod:`.export_reference`)."""
