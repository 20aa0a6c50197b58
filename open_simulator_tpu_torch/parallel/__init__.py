"""Device meshes for the port: parallel/mesh.py lays the cluster state out
over a grid of slots, parallel/slots.py runs code once per slot and holds
the node-axis combines."""
