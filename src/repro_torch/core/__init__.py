"""The ABA core of the port: auction LAP, objectives, dense and streaming scans."""
