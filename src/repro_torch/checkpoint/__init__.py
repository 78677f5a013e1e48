"""Weight bridge between the JAX reference's parameter trees and the port."""
