# Analysis: the traced step's collectives and costs + roofline model.
