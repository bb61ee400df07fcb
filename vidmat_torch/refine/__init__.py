"""Refinement helpers of the port (counterpart of vidmat/refine/)."""
