"""Drivers of the port: serving, and the training driver's cluster layout
(``train.default_slices``)."""
