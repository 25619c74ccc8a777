"""Query engine (numpy oracle, copied) and the PyTorch device backend."""
