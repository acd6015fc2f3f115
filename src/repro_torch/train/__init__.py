"""LM substrate: the AdamW optimizer (fp32 and 8-bit state) and the train
step."""
