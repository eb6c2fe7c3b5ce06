# Command-line entry points, port of `repro.launch`: train.py (the zoo's LM
# training and the paper's Stage-1 objectives). Not ported: mesh.py and
# dryrun.py (they wait for the distributed slice).
