# Command-line entry points and meshes, port of `repro.launch`: train.py
# (the zoo's LM training and the paper's Stage-1 objectives) and mesh.py.
# Not ported: dryrun.py.
