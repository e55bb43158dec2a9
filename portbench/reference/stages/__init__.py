"""One stage of an encoder per module, named by the ``stage`` of a
configuration's ``stages`` entry; each has ``output(x, p, prec, encoder)``:
the stage's result on the input ``x`` with the weights ``p`` (the entry's
``weights`` module's, under their own names) in the precision ``prec``,
``encoder`` being the configuration's reference encoder module."""
