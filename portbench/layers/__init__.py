"""Layers whose kernels a roofline reads: ``matches(kernel name)`` says
which device operations are the layer's, ``work(config, traffic)`` lists
its work for one dispatch at the cell's shapes (``yardstick.Work``)."""
