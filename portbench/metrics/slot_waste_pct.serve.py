"""slot_waste_pct.serve: decode slot-steps spent on slots whose request
had finished (a wave decodes to its longest max_new) over all of the
window's slot-steps, counted from the decode calls the engine made."""

from portbench import readers


def read(rec):
    return readers.slot_waste_pct(rec)
