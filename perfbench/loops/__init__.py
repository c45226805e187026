"""The general generators of traffic, one module a kind.  A traffic mix is
a data file (``perfbench/traffic/<mix>.json``) whose ``kind`` names the
module here that reads it; a new mix of a kind that exists is a new data
file only.

Each module defines ``Loop(cfg, traffic, seed, device, clock)``, which does
its set-up on construction and then offers:

  ``unit()``          one unit of the window (a group of fits, a flush
                      cycle); returns how many units it completed
  ``finish()``        completes what the window left queued
  ``end_to_end(s)``   the cell's end-to-end values over ``s`` seconds
  ``free()``          drops the program's state, keeping what the check
                      and the readers need
  ``check()``         ``{name: (value, limit)}`` against the reference
  ``reader_context()`` what the per-layer readers may read
"""
