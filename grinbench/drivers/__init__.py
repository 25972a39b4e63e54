"""One driver a program entry point.  Each module has

  inputs(cell)                      what the benchmark makes from the seed
  setup(cell, inputs)               the program's objects, warmed up
  window(cell, inputs, state, win)  the measured work: end-to-end metrics
  free(state)                       the program's record, its state freed
  reference(cell, inputs, record, precision, fault)
                                    the plain reference's record and the
                                    work of one unit for the rooflines
  gaps(record, reference_record)    the numbers that decide ``correct``
"""
