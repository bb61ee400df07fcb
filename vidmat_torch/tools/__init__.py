"""Tools of the port (counterparts of the JAX package's ``tools/``): the
measurement tools run on the card; the evaluation, training and weight
tools take ``--device`` or run on the host."""
