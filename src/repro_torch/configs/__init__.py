"""Model configurations the port serves, by architecture id."""
