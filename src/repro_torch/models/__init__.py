"""LM substrate: the reference's models on torch, parameters in `nn.Module`
trees keyed like the reference's dict trees (`common.Params`)."""
