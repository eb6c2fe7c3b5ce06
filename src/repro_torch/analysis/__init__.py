"""Step analysis of the port: the H100's published peaks and each kernel's
work (`costs`), a count of one step's products, bytes, collectives and
live bytes taken while it runs, on meta tensors, the CPU or the card
(`counting`), the three-term roofline on the H100 (`roofline`) and the
dry-run's table (`report`). Port of `repro.analysis`."""
