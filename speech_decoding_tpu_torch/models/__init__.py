"""Brain encoder (eval path) and the weight bridges."""
