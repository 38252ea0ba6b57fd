"""`compact_s.orset3-merge8`: the mean wall of the window's compactions
(``Core.open`` -> ``Core.compact()`` of a fresh replica), in s, by the
host's clock."""


def read(run):
    walls = run["walls"]
    return sum(walls) / len(walls) if walls else None
