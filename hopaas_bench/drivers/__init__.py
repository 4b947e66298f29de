"""One generator for each kind of traffic (a traffic file's ``kind``)."""
