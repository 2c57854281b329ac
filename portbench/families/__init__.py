"""The program's side of each code family: the port's code built from the
configuration's table file, through the port's own parser."""
