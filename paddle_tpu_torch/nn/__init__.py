"""Neural-network building blocks of the port."""
