"""Cost accounting of the port (the reference's ``analysis`` package):

  flops.py        parameter counts and the analytic MODEL_FLOPS
  bytes_model.py  itemized analytic HBM bytes per device per step
  roofline.py     three-term roofline at the H100's rates
  comm.py         collective inventory: the reference's HLO-text parser
                  and the traced counts of DTensor collectives
  pieces.py       per-unit cost pieces the roofline composes
"""
