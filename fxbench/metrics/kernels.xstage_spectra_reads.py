"""The CTAs of the X stage that stage each bin tile's spectra in shared
memory: the program's counter ``fx_xstage.spectra_reads`` (its launch
plan's ``XStagePlan.reads``, summed over the traced calls' X launches),
over those launches (``fx_xstage``).  A property of the plan, 2 on
MeerKAT's tiled instance and 8 on LEDA's band instance: it counts the
spectrum loads a launch issues, not the bytes device memory serves (the
re-reads may come from L2).  Nothing where the program keeps no such
counter or no X kernel ran in the traced calls."""


def read(record):
    counters = record.counters or {}
    reads, launches = (counters.get("fx_xstage.spectra_reads"),
                       counters.get("fx_xstage"))
    if not reads or not launches:
        return None
    return reads / launches
