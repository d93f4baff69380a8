"""Brain encoder, CLIP loss, retrieval metrics and the weight bridges."""
