"""Plain PyTorch references, one file per kind of model.  They import
nothing of the program and take nothing it made: the benchmark hands them
the weights and token ids it made itself."""
