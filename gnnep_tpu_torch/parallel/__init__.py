"""Multi-device paths: the mesh of rank processes, the graph-aligned and
boundary-exchange train steps, member-parallel ensembles and giant graphs."""
